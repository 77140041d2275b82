"""``launch/specs``, ``launch/dryrun``, ``launch/roofline`` and
``launch/report`` of the port against the reference's, on the CPU.

The port's dry-run runs a cell eagerly on fake tensors as one rank of a
fake process group; the reference compiles it with XLA. On a (2, 4)
``data × model`` mesh at the smoke configs (the test's own ``Auto``-axes
mesh of the 8 forced host devices for the reference, a fake group of 8
for the port; ``SHAPES`` patched to short sequences in both packages) the
per-device argument bytes equal XLA's ``memory_analysis()`` (the
reference compiled with ``keep_unused=True``: by default ``jax.jit``
drops the prefill's unused ``weights``), and the output bytes equal it
less XLA's output tuple (8 bytes per output leaf). Every test that
initialises a fake group destroys it on the way out.
"""
import contextlib
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from repro_torch import configs as tcfgs
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import report as treport
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.models import api as tapi
from repro_torch.models import param as tparam

CELLS = [(a, s) for a in tcfgs.ARCHS for s in tcfgs.SHAPES
         if tcfgs.cell_applicable(a, s)[0]]
SMOKE_SHAPES = {"train_4k": (128, 8), "prefill_32k": (256, 8),
                "decode_32k": (256, 8)}


def _jroof():
    """The reference's ``launch/roofline`` (its import sets ``XLA_FLAGS``
    for its own CLI: restored here, after the backend is up)."""
    import jax
    jax.devices()
    flags = os.environ.get("XLA_FLAGS")
    from repro.launch import roofline
    if flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = flags
    return roofline


@contextlib.contextmanager
def _shapes(shapes):
    """``SHAPES`` patched in both packages."""
    from repro import configs as jcfgs
    saved = [dict(d) for d in (jcfgs.SHAPES, tcfgs.SHAPES)]
    for d in (jcfgs.SHAPES, tcfgs.SHAPES):
        d.update(shapes)
    try:
        yield
    finally:
        for d, s in zip((jcfgs.SHAPES, tcfgs.SHAPES), saved):
            d.clear()
            d.update(s)


def _tree_paths(tree, prefix=""):
    """``(path, leaf)`` of a port state (``KVCache`` fields by name)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if hasattr(tree, "window"):
        tree = {"k": tree.k, "v": tree.v, "position": tree.position}
    return list(tparam.leaves(tree, prefix))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every input of every applicable cell at full width: shapes and
    dtypes the reference's (nothing allocated)."""
    import jax
    from repro.launch import specs as jspecs
    got = tspecs.input_specs(arch, shape)
    want = jspecs.input_specs(arch, shape)
    jflat = {jax.tree_util.keystr(p).replace("['", ".").replace("']", "")
             .replace("[", ".").replace("]", "").lstrip("."): v
             for p, v in jax.tree_util.tree_leaves_with_path(want)}
    tflat = {}
    for k, v in got.items():
        for p, t in _tree_paths(v, k):
            tflat[p] = t
    assert sorted(tflat) == sorted(jflat)
    for p, t in tflat.items():
        assert t.device.type == "meta", p
        assert tuple(t.shape) == tuple(jflat[p].shape), p
        assert str(t.dtype).split(".")[1] == str(jflat[p].dtype), p


def _xla_compiled(arch, shape, over=None):
    """The reference's program of the cell at the smoke config (with
    ``over``), compiled for the test's (2, 4) ``Auto``-axes mesh; and
    its number of output leaves."""
    import jax
    from jax.sharding import AxisType
    from repro import configs as jcfgs
    from repro.distributed import sharding as jshd
    from repro.launch import specs as jspecs
    jm = jax.make_mesh((2, 4), ("data", "model"),
                       axis_types=(AxisType.Auto,) * 2)
    jc = jcfgs.get_config(arch, smoke=True).replace(**(over or {}))
    prog = jspecs.build_program(arch, shape, jm, cfg_override=jc)
    with jshd.use_mesh(jm, jshd.build_rules(jc, jm)):
        comp = jax.jit(prog.fn, in_shardings=prog.in_shardings,
                       out_shardings=prog.out_shardings,
                       keep_unused=True).lower(*prog.args).compile()
    n_out = len(jax.tree_util.tree_leaves(jax.eval_shape(prog.fn,
                                                         *prog.args)))
    return comp, n_out


def _xla_memory(arch, shape):
    comp, n_out = _xla_compiled(arch, shape)
    return comp.memory_analysis(), n_out


def _port_run(arch, shape, mesh_shape=(2, 4), axes=("data", "model"),
              over=None):
    tc = tcfgs.get_config(arch, smoke=True).replace(**(over or {}))
    from torch._subclasses.fake_tensor import FakeTensorMode
    with tmesh.fake_group(int(np.prod(mesh_shape))):
        mesh = tmesh._device_mesh(mesh_shape, axes, "cpu")
        prog = tspecs.build_program(arch, shape, mesh, cfg_override=tc)
        with FakeTensorMode():
            args = tdry.program_inputs(prog, lambda s, dt: torch.empty(
                s, dtype=dt))
            out, counter, _ = tdry.run_program(prog, args, tc)
            return (tdry.local_bytes(args), tdry.local_bytes(out),
                    len(tdry.tree_leaves(out)), counter)


@pytest.mark.parametrize("shape", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ["phi4-mini-3.8b", "granite-moe-3b-a800m"])
def test_per_device_bytes_equal_xla(arch, shape):
    with _shapes(SMOKE_SHAPES):
        mem, n_out = _xla_memory(arch, shape)
        args, outs, n_port, counter = _port_run(arch, shape)
    assert args == mem.argument_size_in_bytes
    assert n_port == n_out
    assert outs + 8 * n_out == mem.output_size_in_bytes
    assert counter.flops > 0 and counter.peak > 0
    if shape != "decode_32k":
        assert sum(counter.coll_counts.values()) > 0


_DEF = re.compile(r"%([\w.\-]+) = \w+\[([\d,]*)\]")
_DOT = re.compile(r"%[\w.\-]+ = \w+\[([\d,]*)\]\S* "
                  r"dot\(%([\w.\-]+), %([\w.\-]+)\)")
_CONTRACT = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")
_COLL = re.compile(r"= \S+ (all-reduce|all-gather|reduce-scatter|"
                   r"all-to-all|collective-permute)(?:-start)?\(")


def _ints(text):
    return [int(x) for x in text.split(",") if x]


def _hlo_dots_and_collectives(text):
    """From a compiled module's text (one device's program): the FLOPs of
    its ``dot`` s, 2 x output elements x contracted elements (operand
    shapes looked up by name), and its collectives per kind."""
    shapes = {m.group(1): _ints(m.group(2)) for m in _DEF.finditer(text)}
    flops, kinds = 0, {}
    for line in text.splitlines():
        c = _COLL.search(line)
        if c:
            kinds[c.group(1)] = kinds.get(c.group(1), 0) + 1
        m = _DOT.search(line)
        if m:
            lhs = shapes[m.group(2)]
            k = math.prod(lhs[i] for i in _ints(_CONTRACT.search(line)
                                                .group(1)))
            flops += 2 * math.prod(_ints(m.group(1))) * k
    return flops, kinds


#: ``(arch, overrides, shape) → (low, high)``: the port's counted FLOPs
#: per device over the matmul FLOPs of XLA's partitioned program. With 4
#: KV heads both plans shard the heads over ``model = 4`` and phi4-mini's
#: products are the same, one for one. The MoE computes its router's
#: (64 x 8) product whole on every ``model`` rank, where XLA splits the
#: experts (2-3 % at this width, where the router is 8 of the block's
#: columns). With phi4-mini's own 2 KV heads the mode is ``attn_seq``:
#: the port computes K and V over the whole sequence on every ``model``
#: rank (replicated, as their rules say), XLA over each rank's part of the
#: sequence before gathering them.
XLA_FLOPS = {
    **{("phi4-mini-3.8b", "kv4", s): (1.0, 1.0) for s in SMOKE_SHAPES},
    **{("granite-moe-3b-a800m", "kv4", s): (1.0, 1.04)
       for s in SMOKE_SHAPES},
    ("phi4-mini-3.8b", "own", "decode_32k"): (1.0, 1.0),
    ("phi4-mini-3.8b", "own", "prefill_32k"): (1.0, 1.1),
    ("phi4-mini-3.8b", "own", "train_4k"): (1.0, 1.3),
}


@pytest.mark.parametrize("arch,heads,shape", sorted(XLA_FLOPS))
def test_counted_flops_against_xla(arch, heads, shape):
    """The dry-run counter's FLOPs per device, on a (2, 4) mesh at the
    smoke config, against the ``dot`` FLOPs of the reference's program
    that XLA partitioned for the same mesh (no layer scan and no
    attention-block scan, so that every dot is in the text once per
    execution). Where the counts must agree (serving, as the plans do),
    the collectives per kind too: XLA's training program moves its
    gradients with collective-permutes and all-reduces where ``DTensor``
    reduce-scatters, so its kinds are not the port's there."""
    over = {"scan_layers": False, "attn_unroll": True}
    if heads == "kv4":
        over["num_kv_heads"] = 4
    with _shapes(SMOKE_SHAPES):
        comp, _ = _xla_compiled(arch, shape, over)
        *_, counter = _port_run(arch, shape, over=over)
    xla_flops, xla_kinds = _hlo_dots_and_collectives(comp.as_text())
    low, high = XLA_FLOPS[(arch, heads, shape)]
    assert low * xla_flops <= counter.flops <= high * xla_flops, (
        counter.flops, xla_flops)
    if arch == "phi4-mini-3.8b" and shape != "train_4k" and (
            heads == "kv4" or shape == "decode_32k"):
        assert {k: v for k, v in counter.coll_counts.items() if v} == \
            xla_kinds


@pytest.mark.parametrize("shape", sorted(tcfgs.SHAPES))
@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_model_flops_match_reference(arch, shape):
    from repro import configs as jcfgs
    jroof = _jroof()
    seq, batch = tcfgs.SHAPES[shape]
    for mode in ("train", "prefill", "decode"):
        assert troof.model_flops(tcfgs.get_config(arch), mode, seq, batch) \
            == jroof.model_flops(jcfgs.get_config(arch), mode, seq, batch)


def _records():
    """Reference-format records: OK, SKIP and FAIL rows."""
    ok = {"arch": "phi4-mini-3.8b", "shape": "train_4k", "mode": "train",
          "mesh": "16x16", "status": "OK", "lower_sec": 3.2,
          "compile_sec": 9.7, "flops_per_device": 3.3e14,
          "bytes_per_device": 1.9e12, "collective_bytes_per_device": 7.1e10,
          "collectives": {}, "collective_counts": {
              "all-reduce": 12, "all-gather": 40, "reduce-scatter": 3,
              "all-to-all": 0, "collective-permute": 0},
          "memory": {"argument_bytes": 2_842_306_884,
                     "output_bytes": 2_842_044_692,
                     "temp_bytes": 28_568_109_068, "alias_bytes": 0},
          "model_flops_per_device": 2.9e14}
    skip = {"arch": "llama3-405b", "shape": "long_500k", "status": "SKIP",
            "reason": "full-attention arch: 500k-token decode needs "
                      "sub-quadratic attention (skip noted in DESIGN.md §5)"}
    fail = {"arch": "kimi-k2-1t-a32b", "shape": "decode_32k",
            "status": "FAIL", "error": "RuntimeError: out of the plan"}
    return ok, skip, fail


def test_roofline_terms_match_reference_at_v5e():
    """The terms of one record with the reference's v5e figures as the
    input, equal to the reference's; at the H100 figures, the record's
    numbers over the H100's rates."""
    jroof = _jroof()
    rec = _records()[0]
    assert troof.roofline_terms(rec, tmesh.TPU_V5E) == jroof.roofline_terms(
        rec)
    h = troof.roofline_terms(rec)
    assert h["compute_sec"] == rec["flops_per_device"] / 989e12
    assert h["memory_sec"] == rec["bytes_per_device"] / 3.35e12
    assert h["collective_sec"] == rec["collective_bytes_per_device"] / 450e9


def test_report_tables_match_reference(tmp_path):
    """The three tables, string for string the reference's on the same
    records; the port's own records head the time column ``trace s``."""
    from repro.launch import report as jreport
    jroof = _jroof()
    ok, skip, fail = _records()
    roof = dict(ok, **jroof.roofline_terms(ok))
    paths = {}
    for name, rows in (("dry", [ok, skip, fail]), ("roof", [roof, skip]),
                       ("hill", [dict(roof, label="iteration 3")])):
        paths[name] = str(tmp_path / f"{name}.jsonl")
        with open(paths[name], "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    assert treport.dryrun_table(paths["dry"], "T") == jreport.dryrun_table(
        paths["dry"], "T")
    assert treport.roofline_table(paths["roof"]) == jreport.roofline_table(
        paths["roof"])
    assert treport.hillclimb_table(paths["hill"]) == \
        jreport.hillclimb_table(paths["hill"])
    mine = dict(ok, trace_sec=22.5)
    del mine["compile_sec"], mine["lower_sec"]
    with open(paths["dry"], "w") as f:
        f.write(json.dumps(mine) + "\n")
    table = treport.dryrun_table(paths["dry"], "T")
    assert "| trace s |" in table and "| OK | 22.5 |" in table


def test_probe_extrapolation_matches_full_trace():
    """At a smoke config of 4 layers: flops, bytes and collective bytes
    extrapolated from the 1- and 2-layer probes equal a trace of all 4
    (each layer is the same work)."""
    cfg = tcfgs.get_config("phi4-mini-3.8b", smoke=True).replace(
        num_layers=4)
    with _shapes({"prefill_32k": (64, 32)}):
        probe = troof.probe_cell("phi4-mini-3.8b", "prefill_32k",
                                 verbose=False, cfg_override=cfg)
        full = tdry.run_cell("phi4-mini-3.8b", "prefill_32k",
                             cfg_override=cfg, verbose=False)
    assert [p["L"] for p in probe["probe_points"]] == [1, 2]
    for key in ("flops_per_device", "bytes_per_device",
                "collective_bytes_per_device"):
        np.testing.assert_allclose(probe[key], full[key], rtol=1e-12)
    assert probe["model_flops_per_device"] == troof.model_flops(
        cfg, "prefill", 64, 32) / 256


def test_run_cell_arguments_are_the_shards():
    """``run_cell`` at a smoke config on the (16, 16) fake mesh: the
    record's argument bytes are the sum of the shard bytes worked out
    from ``param_specs`` and the input shapes alone."""
    cfg = tcfgs.get_config("phi4-mini-3.8b", smoke=True)
    with _shapes({"decode_32k": (64, 32)}):
        rec = tdry.run_cell("phi4-mini-3.8b", "decode_32k",
                            cfg_override=cfg, verbose=False)
        inputs = tspecs.input_specs("phi4-mini-3.8b", "decode_32k", cfg)
    mesh = tshd.AbstractMesh({"data": 16, "model": 16})
    rules = tshd.build_rules(cfg, mesh)
    skel = tapi.skeleton(cfg)
    with tshd.use_mesh(None, rules):
        specs = dict(tparam.leaves(tparam.param_specs(skel, mesh)))
        want = 0
        for path, s in tparam.leaves(skel):
            shape = _local(specs[path], s.shape, mesh)
            want += int(np.prod(shape)) * s.dtype.itemsize
        for path, t in _tree_paths(inputs["state"], "state"):
            logical = (("layers", "batch", "kv_seq", "kv_heads", None)
                       if t.dim() == 5 else
                       ("batch",) + (None,) * (t.dim() - 1)
                       if t.dim() and t.shape[0] == 32 else
                       (None,) * t.dim())
            spec = tshd.resolve_spec(logical, t.shape, mesh)
            want += int(np.prod(_local(spec, t.shape, mesh))) * \
                t.element_size()
        want += 32 // 16 * 4                      # tokens [32, 1]
    assert rec["status"] == "OK"
    assert rec["memory"]["argument_bytes"] == want
    assert rec["flops_per_device"] > 0


def _local(spec, shape, mesh):
    sizes = tshd.axis_sizes(mesh)
    out = []
    for entry, d in zip(spec, shape):
        axes = entry if isinstance(entry, tuple) else (entry,)
        out.append(d // int(np.prod([sizes[a] for a in axes if a])))
    return out
