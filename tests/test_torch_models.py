"""The port's model configs and dense serving path against the reference,
on the CPU.

Configs field by field (dtype by name); parameter counts and bytes for
every full config (the skeletons of the ported families leaf for leaf);
``init_params`` bit for bit (f32 and bf16, whole and sliced draws); the
ssm, moe and hybrid families' entry points on the port's weights carried
to the reference; the encdec and vlm families refused naming ROADMAP item
12c; the layers (``rmsnorm``, ``mlp`` with its four
activations, ``rope``, chunked attention causal / windowed / non-causal /
ragged, ``decode_attention``, ``write_token`` with the clamp and the ring)
in f32 at rtol 1e-5, atol 1e-6; and ``prefill`` / ``decode_step`` of the
phi4 smoke config with the reference's weights carried over, at rtol
1e-4, atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.configs import streamapprox as jsa
from repro.models import api as japi
from repro.models import attention as jattn
from repro.models import kvcache as jkvc
from repro.models import layers as jlayers
from repro.models import param as jparam
from repro.models import transformer as jtr
from repro.models.config import ModelConfig as JConfig
from repro_torch import configs as tcfgs
from repro_torch import prng
from repro_torch.configs import streamapprox as tsa
from repro_torch.models import api as tapi
from repro_torch.models import attention as tattn
from repro_torch.models import kvcache as tkvc
from repro_torch.models import layers as tlayers
from repro_torch.models import param as tparam
from repro_torch.models import transformer as ttr
from repro_torch.models.config import ModelConfig as TConfig
from repro_torch.models.transformer import UnportedModelError

ARCH = "phi4-mini-3.8b"
PORTED = [a for a in jcfgs.ARCHS
          if jcfgs.get_config(a).family in tapi.PORTED]
UNPORTED = [a for a in jcfgs.ARCHS if a not in PORTED]
RTOL, ATOL = 1e-5, 1e-6              # layers, f32
MODEL_RTOL, MODEL_ATOL = 1e-4, 1e-5  # whole model, f32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch intra-op thread per test: the suite runs several worker
    processes on the same cores, and torch's thread pool contending with
    them makes these many small operations tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return str(jnp.dtype(dtype))


def _fields(cfg):
    """A config's fields, its dtype by name."""
    return dict(dataclasses.asdict(cfg), dtype=_dtype_name(cfg.dtype))


def _cfg(arch=ARCH, **kw):
    """The smoke config of ``arch`` in f32, in both packages."""
    return (jcfgs.get_config(arch, smoke=True).replace(dtype=jnp.float32,
                                                       **kw),
            tcfgs.get_config(arch, smoke=True).replace(dtype=torch.float32,
                                                       **kw))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# Configs and parameter skeletons.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", jcfgs.ARCHS)
def test_configs_match_reference(arch):
    for smoke in (False, True):
        j = jcfgs.get_config(arch, smoke=smoke)
        t = tcfgs.get_config(arch, smoke=smoke)
        assert _fields(t) == _fields(j)
        assert (t.is_moe, t.q_size, t.kv_size) == (j.is_moe, j.q_size,
                                                   j.kv_size)


def test_registry_shapes_and_workload_configs_match_reference():
    assert tcfgs.ARCHS == jcfgs.ARCHS
    assert tcfgs.SHAPES == jcfgs.SHAPES
    assert tcfgs.SUBQUADRATIC == jcfgs.SUBQUADRATIC
    for arch in jcfgs.ARCHS:
        for shape in jcfgs.SHAPES:
            assert tcfgs.cell_applicable(arch, shape) == \
                jcfgs.cell_applicable(arch, shape)
    for name in ("PAPER_MICROBENCH", "NETWORK_TRAFFIC", "TAXI_RIDES"):
        assert dataclasses.asdict(getattr(tsa, name)) == \
            dataclasses.asdict(getattr(jsa, name))
    with pytest.raises(KeyError, match="unknown arch"):
        tcfgs.get_config("nope")


def _specs(skel):
    return [(p, s.shape, s.logical, _dtype_name(s.dtype), s.init, s.scale)
            for p, s in tparam.leaves(skel)]


@pytest.mark.parametrize("arch", jcfgs.ARCHS)
def test_param_counts_match_reference(arch):
    """Every full config: the skeletons of the ported families (dense,
    moe, hybrid, ssm) leaf for leaf, lists of blocks included, and the
    counts; the other families' skeletons (not ported) refused, their
    counts taken over the reference's leaves."""
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jskel = japi.skeleton(jcfg)
    want = (jparam.count_params(jskel), jparam.param_bytes(jskel))
    if arch in PORTED:
        tskel = tapi.skeleton(tcfg)
        assert _specs(tskel) == _specs(jskel)
    else:
        with pytest.raises(UnportedModelError, match="item 12"):
            tapi.skeleton(tcfg)
        specs = jax.tree_util.tree_leaves(
            jskel, is_leaf=lambda x: isinstance(x, jparam.ParamSpec))
        tskel = {str(i): tparam.ParamSpec(
            s.shape, s.logical, getattr(torch, _dtype_name(s.dtype)),
            s.init, s.scale) for i, s in enumerate(specs)}
    assert (tparam.count_params(tskel), tparam.param_bytes(tskel)) == want
    full = {ARCH: (4_450_618_368, 8_901_636_096),
            "xlstm-350m": (392_922_208, 786_461_056),
            "granite-moe-3b-a800m": (3_374_295_552, 6_752_722_944),
            "recurrentgemma-9b": (10_444_984_320, 20_890_812_416)}
    if arch in full:
        assert want == full[arch]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_bitwise(dtype):
    jcfg = jcfgs.get_config(ARCH, smoke=True).replace(
        dtype=getattr(jnp, dtype))
    tcfg = tcfgs.get_config(ARCH, smoke=True).replace(
        dtype=getattr(torch, dtype))
    jp = jax.device_get(jparam.init_params(japi.skeleton(jcfg),
                                           jax.random.PRNGKey(0)))
    tp = tparam.init_params(tapi.skeleton(tcfg), prng.PRNGKey(0),
                            device="cpu")
    back = tparam.params_to_reference(tp)
    assert [p for p, _ in tparam.leaves(back)] == \
        [p for p, _ in tparam.leaves(jp)]
    for (_, a), (_, b) in zip(tparam.leaves(jp), tparam.leaves(back)):
        _same_bits(a, b)


def test_sliced_draws_are_the_whole_draw(monkeypatch):
    """A draw in slices (any slice size, a ragged last one) is bit for
    bit the whole draw, and so is ``init_params`` in slices."""
    key = prng.fold_in(prng.PRNGKey(3), 7)
    whole = prng.normal(key, 10_000)
    for size in (97, 333, 4096):
        parts = torch.cat([prng.normal(key, min(size, 10_000 - s), s)
                           for s in range(0, 10_000, size)])
        assert torch.equal(parts.view(torch.int32), whole.view(torch.int32))
    tcfg = tcfgs.get_config(ARCH, smoke=True)
    skel = tapi.skeleton(tcfg)
    full = tparam.init_params(skel, prng.PRNGKey(0), device="cpu")
    monkeypatch.setattr(tparam, "INIT_SLICE", 1000)
    sliced = tparam.init_params(skel, prng.PRNGKey(0), device="cpu")
    for (_, a), (_, b) in zip(tparam.leaves(full), tparam.leaves(sliced)):
        _same_bits(tparam.params_to_reference({"x": a})["x"],
                   tparam.params_to_reference({"x": b})["x"])


def test_params_carry_over_round_trip():
    jcfg, tcfg = _cfg()
    jp = jax.device_get(jparam.init_params(japi.skeleton(jcfg),
                                           jax.random.PRNGKey(5)))
    tp = tparam.params_from_reference(jp, device="cpu")
    assert [p for p, _ in tparam.leaves(tp)] == \
        [p for p, _ in tparam.leaves(jp)]
    assert tp["dense_layers"]["attn"]["wq"].shape == (2, 64, 2, 2, 16)
    for (_, a), (_, b) in zip(tparam.leaves(jp), tparam.leaves(
            tparam.params_to_reference(tp))):
        _same_bits(a, b)


@pytest.mark.parametrize("arch", UNPORTED)
def test_other_families_refused_naming_the_roadmap(arch):
    _, tcfg = _cfg(arch)
    for fn in (tapi.skeleton, tapi.prefill_fn, tapi.decode_fn,
               tapi.loss_fn):
        with pytest.raises(UnportedModelError, match="item 12c"):
            fn(tcfg)


@pytest.mark.parametrize("arch", [a for a in PORTED if jcfgs.get_config(
    a).family != "dense"])
def test_other_families_match_reference(arch):
    """The decoder-only families beyond dense (ssm, moe, hybrid), each
    through the entry points a user calls, the port's ``init_params``
    carried to the reference: the smoke skeleton leaf for leaf, the
    prefill's and one decode step's logits and the weighted loss within
    the whole model's rtol 1e-4 / atol 1e-5, ``init_decode_state``'s
    leaves shape for shape and the positions equal."""
    jcfg, tcfg = _cfg(arch)
    tskel = tapi.skeleton(tcfg)
    assert _specs(tskel) == _specs(japi.skeleton(jcfg))
    tp = tparam.init_params(tskel, prng.PRNGKey(0), device="cpu")
    jp = tparam.params_to_reference(tp)
    toks = np.random.default_rng(4).integers(0, 512, (2, 12)).astype(
        np.int32)
    w = np.array([1.0, 2.5], np.float32)
    jl, jst = jax.jit(lambda p, t: japi.prefill_fn(jcfg)(
        p, {"tokens": t}))(jp, jnp.asarray(toks))
    nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    jl2, _ = jax.jit(japi.decode_fn(jcfg))(jp, jst, jnp.asarray(nxt))
    jloss = jax.jit(japi.loss_fn(jcfg))(
        jp, {"tokens": jnp.asarray(toks), "weights": jnp.asarray(w)})[0]
    with torch.inference_mode():
        tl, tst = tapi.prefill_fn(tcfg)(tp, {"tokens": _t(toks)})
        tl2, _ = tapi.decode_fn(tcfg)(tp, tst, _t(nxt))
        tloss = tapi.loss_fn(tcfg)(tp, {"tokens": _t(toks),
                                        "weights": _t(w)})[0]
    for got, want in ((tl, jl), (tl2, jl2), (tloss, jloss)):
        _close(got, want, MODEL_RTOL, MODEL_ATOL)
    js = japi.init_decode_state(jcfg, 2, 20)
    ts = tapi.init_decode_state(tcfg, 2, 20, device="cpu")
    jshapes = [(p, np.shape(a)) for p, a in tparam.leaves(
        tapi.state_tree(js))]
    assert [(p, tuple(t.shape)) for p, t in tparam.leaves(
        tapi.state_tree(ts))] == jshapes
    assert int(tapi.state_tree(ts)["position"]) == 20


# ---------------------------------------------------------------------------
# Layers, f32.
# ---------------------------------------------------------------------------

def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def test_rmsnorm_matches_reference():
    x = _normal(0, (3, 5, 64), 2.0)
    scale = _normal(1, (64,)) + 1.0
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                           1e-5)
    _close(tlayers.rmsnorm({"scale": _t(scale)}, _t(x), 1e-5), want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_reference(act):
    jcfg, tcfg = _cfg(mlp_activation=act)
    skel = jlayers.mlp_skeleton(jcfg)
    p = {k: _normal(i, s.shape, 0.1) for i, (k, s) in
         enumerate(sorted(skel.items()))}
    x = _normal(9, (2, 7, 64))
    want = jlayers.mlp({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x), jcfg)
    got = tlayers.mlp({k: _t(v) for k, v in p.items()}, _t(x), tcfg)
    _close(got, want)


def test_embed_unembed_match_reference():
    table = _normal(0, (50, 16))
    w = _normal(1, (16, 50))
    toks = np.random.default_rng(2).integers(0, 50, (3, 4)).astype(np.int32)
    _close(tlayers.embed({"tokens": _t(table)}, _t(toks)),
           jlayers.embed({"tokens": jnp.asarray(table)}, jnp.asarray(toks)))
    x = _normal(3, (3, 4, 16))
    got = tlayers.unembed({"w": _t(w)}, _t(x))
    assert got.dtype == torch.float32
    _close(got, jlayers.unembed({"w": jnp.asarray(w)}, jnp.asarray(x)))


def test_rope_matches_reference():
    x = _normal(0, (2, 9, 3, 2, 16), 3.0)
    for pos in (np.arange(9, dtype=np.int32), np.array([37], np.int32)):
        xs = x[:, :len(pos)]
        want = jattn.rope(jnp.asarray(xs), jnp.asarray(pos), 10000.0)
        _close(tattn.rope(_t(xs), _t(pos), 10000.0), want)


def _qkv(seed, b=2, s=48, hkv=2, g=2, hd=8, skv=None):
    skv = skv or s
    return (_normal(seed, (b, s, hkv, g, hd)),
            _normal(seed + 1, (b, skv, hkv, hd)),
            _normal(seed + 2, (b, skv, hkv, hd)))


def _attn_cfg(qc=16, ck=16):
    kw = dict(name="t", family="dense", num_layers=1, d_model=32,
              num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
              head_dim=8, attn_q_chunk=qc, attn_kv_chunk=ck, remat="none")
    return JConfig(dtype=jnp.float32, **kw), TConfig(dtype=torch.float32,
                                                     **kw)


@pytest.mark.parametrize("case", [
    dict(),                                    # causal
    dict(window=12),                           # local window
    dict(window=5, qc=8, ck=16),               # window, qc != ck
    dict(causal=False, skv=37),                # non-causal, Sq != Skv
    dict(s=41),                                # S not a multiple
    dict(s=41, qc=16, ck=8),                   # ragged, qc != ck
    dict(s=10, qc=16, ck=16),                  # S below one block
], ids=["causal", "window", "window_qc8", "noncausal", "ragged",
        "ragged_ck8", "short"])
def test_chunked_attention_matches_reference(case):
    case = dict(case)
    jcfg, tcfg = _attn_cfg(case.pop("qc", 16), case.pop("ck", 16))
    q, k, v = _qkv(4, s=case.pop("s", 48), skv=case.pop("skv", None))
    want = jattn.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jcfg, **case)
    got = tattn.chunked_causal_attention(_t(q), _t(k), _t(v), tcfg, **case)
    assert tuple(got.shape) == q.shape
    _close(got, want)


@pytest.mark.parametrize("valid", [1, 13, 40])
def test_decode_attention_matches_reference(valid):
    q = _normal(0, (2, 1, 2, 3, 8))
    kc, vc = _normal(1, (2, 40, 2, 8)), _normal(2, (2, 40, 2, 8))
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(valid))
    got = tattn.decode_attention(_t(q), _t(kc), _t(vc),
                                 torch.tensor(valid, dtype=torch.int32))
    _close(got, want)


@pytest.mark.parametrize("position,window", [
    (0, 0), (5, 0), (7, 0), (8, 0), (11, 0),     # 8, 11: clamped to 7
    (3, 4), (9, 4), (6, 16)])                    # ring; 6 % 16 clamped
def test_write_token_matches_reference(position, window):
    """Plain caches write at ``position``, ring caches at ``position %
    window``, and a slot past ``Smax - 1`` is clamped as XLA clamps it."""
    smax = 8
    lk, lv = _normal(0, (2, smax, 2, 4)), _normal(1, (2, smax, 2, 4))
    kn, vn = _normal(2, (2, 1, 2, 4)), _normal(3, (2, 1, 2, 4))
    jcache = jkvc.KVCache(k=None, v=None,
                          position=jnp.asarray(position, jnp.int32),
                          window=window)
    tcache = tkvc.KVCache(k=torch.zeros(1, 2, smax, 2, 4), v=None,
                          position=torch.tensor(position,
                                                dtype=torch.int32),
                          window=window)
    wk, wv = jkvc.write_token(jnp.asarray(lk), jnp.asarray(lv), jcache,
                              jnp.asarray(kn), jnp.asarray(vn))
    tk, tv = _t(lk), _t(lv)
    out = tkvc.write_token(tk, tv, tcache, _t(kn), _t(vn))
    assert out[0] is tk and out[1] is tv          # in place
    _same_bits(np.asarray(wk), tk.numpy())
    _same_bits(np.asarray(wv), tv.numpy())
    assert int(tkvc.cache_len(tcache)) == int(jkvc.cache_len(jcache))


# ---------------------------------------------------------------------------
# The model: prefill and decode, weights carried from the reference.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_len", [0, 80])
def test_prefill_and_decode_match_reference(max_len):
    jcfg, tcfg = _cfg()
    jp = jparam.init_params(japi.skeleton(jcfg), jax.random.PRNGKey(0))
    tp = tparam.params_from_reference(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(0).integers(0, 512, (3, 70)).astype(
        np.int32)
    jl, jcache = japi.prefill_fn(jcfg)(jp, {"tokens": jnp.asarray(toks)},
                                       max_len=max_len)
    with torch.inference_mode():
        tl, tcache = tapi.prefill_fn(tcfg)(tp, {"tokens": _t(toks)},
                                           max_len=max_len)

        def check():
            _close(tl, jl, MODEL_RTOL, MODEL_ATOL)
            assert tl.dtype == torch.float32
            for f in ("k", "v"):
                _close(getattr(tcache, f), getattr(jcache, f), MODEL_RTOL,
                       MODEL_ATOL)
            assert tcache.position.dtype == torch.int32
            assert int(tcache.position) == int(jcache.position)
        check()
        for _ in range(3):
            nxt = np.argmax(np.asarray(jl)[:, -1], -1).astype(
                np.int32)[:, None]
            jl, jcache = japi.decode_fn(jcfg)(jp, jcache, jnp.asarray(nxt))
            tl, tcache = tapi.decode_fn(tcfg)(tp, tcache, _t(nxt))
            check()


def test_hidden_states_and_decode_state_match_reference():
    jcfg, tcfg = _cfg()
    jp = jparam.init_params(japi.skeleton(jcfg), jax.random.PRNGKey(1))
    tp = tparam.params_from_reference(jax.device_get(jp), device="cpu")
    toks = np.random.default_rng(1).integers(0, 512, (2, 33)).astype(
        np.int32)
    _close(ttr.hidden_states(tp, _t(toks), tcfg),
           jtr.hidden_states(jp, jnp.asarray(toks), jcfg), MODEL_RTOL,
           MODEL_ATOL)
    js = japi.init_decode_state(jcfg, 3, 20)
    ts = tapi.init_decode_state(tcfg, 3, 20, device="cpu")
    assert tuple(ts.k.shape) == js.k.shape and ts.k.dtype == torch.float32
    assert int(ts.position) == int(js.position) == 20
