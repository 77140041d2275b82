"""Roofline analysis: per-device compute, memory and collective terms.

Counterpart of the reference's ``launch/roofline.py``. ``model_flops``
and its helpers are the reference's arithmetic on the config, line for
line (the analytic matmul FLOPs of one step, the "useful compute"
yardstick). ``probe_cell`` keeps the reference's probes and
extrapolations to the full depth:

  transformer families:  f(L) linear          → probe L ∈ {1, 2}
  hybrid (rec,rec,attn): f = α + n_r·r + n_a·a  → probe L ∈ {1, 2, 3}
  ssm (mlstm, slstm):    f(L, S) bilinear     → L ∈ {1, 2, 3} × S ∈ {16, 32}

Each probe is one ``launch/dryrun`` run of the cell at the probe's depth
(and sequence) on the (16, 16) fake mesh. The reference needs the probes
because XLA's ``cost_analysis()`` counts a ``scan`` body once; the eager
dry-run counts every op, so here the probes only save trace time (the
xLSTM's Python time loop at 32,768 tokens is the longest trace of all).
``roofline_terms(rec, hw)`` divides by the figures of a
``launch.mesh.Hardware`` (the H100 SXM5's by default):

  compute    = flops_per_device / hw.peak_flops_bf16
  memory     = bytes_per_device / hw.hbm_bytes_per_s
  collective = collective_bytes_per_device / hw.link_bytes_per_s

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch phi4-mini-3.8b \\
      --shape train_4k [--out results/roofline.jsonl]
  PYTHONPATH=src python -m repro_torch.launch.roofline --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional

from repro_torch import configs as cfgs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import H100_SXM5, Hardware
from repro_torch.models import rglru as rg
from repro_torch.models import xlstm as xl
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS (matmul-only, no remat/recompute).
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, seq: int, batch: int, causal: bool = True,
                kv_len: Optional[int] = None, window: Optional[int] = None
                ) -> float:
    """Score + AV matmul FLOPs for one layer."""
    kv = kv_len if kv_len is not None else seq
    if window is not None:
        eff = min(window, kv)
        pairs = seq * eff - (eff * (eff - 1) / 2 if seq >= eff else 0)
    elif causal and kv == seq:
        pairs = seq * (seq + 1) / 2
    else:
        pairs = seq * kv
    return 2 * 2 * batch * pairs * cfg.num_heads * cfg.head_dim


def _proj_flops(cfg: ModelConfig, tokens: float) -> float:
    d, hd = cfg.d_model, cfg.head_dim
    qkvo = 2 * tokens * d * hd * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    return qkvo


def _mlp_flops(cfg: ModelConfig, tokens: float, d_ff: int) -> float:
    mats = 3 if cfg.mlp_activation in ("swiglu", "geglu") else 2
    return 2 * tokens * cfg.d_model * d_ff * mats


def _layer_flops(cfg: ModelConfig, kind: str, seq: int, batch: int,
                 mode: str) -> float:
    tokens = batch * seq if mode != "decode" else batch
    if kind == "attn" or kind == "dense":
        window = cfg.local_window if cfg.family == "hybrid" else None
        if mode == "decode":
            kv = cfg.local_window if window else seq
            att = _attn_flops(cfg, 1, batch, kv_len=kv)
        else:
            att = _attn_flops(cfg, seq, batch, window=window)
        d_ff = cfg.d_ff or cfg.expert_d_ff * max(
            cfg.num_experts_per_token + cfg.num_shared_experts, 1)
        return _proj_flops(cfg, tokens) + att + _mlp_flops(cfg, tokens,
                                                           d_ff)
    if kind == "moe":
        att = (_attn_flops(cfg, 1, batch, kv_len=seq) if mode == "decode"
               else _attn_flops(cfg, seq, batch))
        active_ff = cfg.expert_d_ff * (cfg.num_experts_per_token +
                                       cfg.num_shared_experts)
        router = 2 * tokens * cfg.d_model * cfg.num_experts
        return (_proj_flops(cfg, tokens) + att + router +
                _mlp_flops(cfg, tokens, active_ff))
    if kind == "rec":   # RG-LRU block
        r = cfg.rnn_width or cfg.d_model
        d = cfg.d_model
        lin = 2 * tokens * d * r * 3 + 2 * tokens * r * r * 2
        conv = 2 * tokens * r * cfg.conv_width
        cell = tokens * r * 8
        return lin + conv + cell + _mlp_flops(cfg, tokens, cfg.d_ff)
    if kind == "mlstm":
        d = cfg.d_model
        di = 2 * d
        hd = di // cfg.num_heads
        lin = 2 * tokens * d * di * 2 + 2 * tokens * di * di * 3 \
            + 2 * tokens * di * d
        cell = tokens * cfg.num_heads * (4 * hd * hd + 6 * hd)
        conv = 2 * tokens * di * cfg.conv_width
        return lin + cell + conv
    if kind == "slstm":
        d = cfg.d_model
        lin = 2 * tokens * d * d * 5
        cell = tokens * d * 10
        conv = 2 * tokens * d * cfg.conv_width
        return lin + cell + conv
    raise ValueError(kind)


def model_flops(cfg: ModelConfig, mode: str, seq: int, batch: int) -> float:
    """Analytic matmul FLOPs of ONE step (forward; ×3 for train fwd+bwd)."""
    tokens = batch * seq if mode != "decode" else batch
    total = 2 * tokens * cfg.d_model * cfg.vocab_size        # logits
    if mode == "train":
        tokens_in = tokens
    else:
        tokens_in = tokens
    # layers
    if cfg.family in ("dense", "vlm"):
        total += cfg.num_layers * _layer_flops(cfg, "dense", seq, batch,
                                               mode)
    elif cfg.family == "moe":
        n_moe = cfg.num_layers - cfg.first_dense_layers
        total += cfg.first_dense_layers * _layer_flops(
            cfg, "dense", seq, batch, mode)
        total += n_moe * _layer_flops(cfg, "moe", seq, batch, mode)
    elif cfg.family == "encdec":
        enc = cfg.num_encoder_layers or cfg.num_layers
        if mode == "decode":
            # decode: self-attn over cache + cross-attn over memory
            total += cfg.num_layers * (
                _proj_flops(cfg, batch) * 2 +
                _attn_flops(cfg, 1, batch, kv_len=seq) * 2 +
                _mlp_flops(cfg, batch, cfg.d_ff))
        else:
            total += enc * (_proj_flops(cfg, tokens) +
                            _attn_flops(cfg, seq, batch, causal=False) +
                            _mlp_flops(cfg, tokens, cfg.d_ff))
            total += cfg.num_layers * (
                _proj_flops(cfg, tokens) * 2 +
                _attn_flops(cfg, seq, batch) +
                _attn_flops(cfg, seq, batch, causal=False) +
                _mlp_flops(cfg, tokens, cfg.d_ff))
    elif cfg.family == "hybrid":
        for i in range(cfg.num_layers):
            kind = "rec" if rg.block_kind(cfg, i) == "rec" else "attn"
            total += _layer_flops(cfg, kind, seq, batch, mode)
    elif cfg.family == "ssm":
        for i in range(cfg.num_layers):
            total += _layer_flops(cfg, xl.block_kind(cfg, i), seq, batch,
                                  mode)
    if mode == "train":
        total *= 3.0          # backward ≈ 2× forward matmuls
    return total


# ---------------------------------------------------------------------------
# Probes + extrapolation
# ---------------------------------------------------------------------------

def _probe_cfg(cfg: ModelConfig, num_layers: int,
               extra: Optional[dict] = None) -> ModelConfig:
    kw = dict(num_layers=num_layers, scan_layers=False, attn_unroll=True)
    if cfg.family == "encdec":
        kw["num_encoder_layers"] = num_layers
    if cfg.family == "moe":
        kw["num_layers"] = cfg.first_dense_layers + num_layers
    if extra:
        kw.update(extra)
    return cfg.replace(**kw)


def _measure(arch: str, shape: str, cfg_variant: ModelConfig,
             seq_override: Optional[int] = None) -> dict:
    """One probe: the dry-run of the cell at ``cfg_variant`` (and at
    ``seq_override`` tokens); its per-device flops, bytes and collective
    bytes."""
    orig = cfgs.SHAPES[shape]
    if seq_override is not None:
        cfgs.SHAPES[shape] = (seq_override, orig[1])
    try:
        rec = dryrun.run_cell(arch, shape, cfg_override=cfg_variant,
                              verbose=False)
    finally:
        cfgs.SHAPES[shape] = orig
    return {"flops": rec["flops_per_device"],
            "bytes": rec["bytes_per_device"],
            "coll": float(rec["collective_bytes_per_device"])}


def probe_cell(arch: str, shape: str, verbose: bool = True,
               cfg_override=None, label: str = "",
               hw: Hardware = H100_SXM5) -> dict:
    """Extrapolated per-device (flops, bytes, collective bytes) of the
    full-size cell, the probe points used, and the roofline terms at
    ``hw``."""
    cfg = cfg_override or cfgs.get_config(arch)
    seq, batch = cfgs.SHAPES[shape]
    mode = ("train" if shape == "train_4k" else
            "prefill" if shape.startswith("prefill") else "decode")
    points = []

    def lin_extrapolate(ls, vals, full_l):
        b = (vals[1] - vals[0]) / (ls[1] - ls[0])
        a = vals[0] - b * ls[0]
        return a + b * full_l

    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        full_l = (cfg.num_layers - cfg.first_dense_layers
                  if cfg.family == "moe" else cfg.num_layers)
        for l in (1, 2):
            m = _measure(arch, shape, _probe_cfg(cfg, l))
            points.append({"L": l, **m})
        out = {k: lin_extrapolate([1, 2],
                                  [points[0][k], points[1][k]], full_l)
               for k in ("flops", "bytes", "coll")}
    elif cfg.family == "hybrid":
        if mode == "decode":
            # looped blocks, O(1) state: exact, no extrapolation
            m = _measure(arch, shape, cfg.replace(attn_unroll=True))
            points.append({"L": cfg.num_layers, **m})
            out = dict(flops=m["flops"], bytes=m["bytes"], coll=m["coll"])
        else:
            ms = [_measure(arch, shape, _probe_cfg(cfg, l))
                  for l in (1, 2, 3)]
            for l, m in zip((1, 2, 3), ms):
                points.append({"L": l, **m})
            n_rec = sum(1 for i in range(cfg.num_layers)
                        if rg.block_kind(cfg, i) == "rec")
            n_att = cfg.num_layers - n_rec
            out = {}
            for k in ("flops", "bytes", "coll"):
                r = ms[1][k] - ms[0][k]            # one rec block
                a = ms[2][k] - ms[1][k]            # one attn block
                alpha = ms[0][k] - r
                out[k] = alpha + n_rec * r + n_att * a
    elif cfg.family == "ssm":
        if mode == "decode":
            m = _measure(arch, shape, cfg)
            points.append({"L": cfg.num_layers, **m})
            out = dict(flops=m["flops"], bytes=m["bytes"], coll=m["coll"])
        else:
            # Tiny probe sequences: the recurrent cell's cost is linear
            # in S.
            s_probes = (16, 32)
            grid = {}
            for l in (1, 2, 3):
                for s in s_probes:
                    m = _measure(arch, shape,
                                 _probe_cfg(cfg, l,
                                            extra={"time_unroll": True}),
                                 seq_override=s)
                    grid[(l, s)] = m
                    points.append({"L": l, "S": s, **m})
            n_m = sum(1 for i in range(cfg.num_layers)
                      if xl.block_kind(cfg, i) == "mlstm")
            n_s = cfg.num_layers - n_m
            out = {}
            for k in ("flops", "bytes", "coll"):
                def line(l):
                    y1, y2 = grid[(l, s_probes[0])][k], \
                        grid[(l, s_probes[1])][k]
                    slope = (y2 - y1) / (s_probes[1] - s_probes[0])
                    return y1 - slope * s_probes[0], slope
                b1 = line(1)   # base + 1 mlstm
                b2 = line(2)   # + slstm
                b3 = line(3)   # + mlstm
                sl = (b2[0] - b1[0], b2[1] - b1[1])
                ml = (b3[0] - b2[0], b3[1] - b2[1])
                base = (b1[0] - ml[0], b1[1] - ml[1])
                icpt = base[0] + n_m * ml[0] + n_s * sl[0]
                slope = base[1] + n_m * ml[1] + n_s * sl[1]
                out[k] = icpt + slope * seq
    else:
        raise ValueError(cfg.family)

    mf = model_flops(cfg, mode, seq, batch)
    rec = {
        "arch": arch, "shape": shape, "mode": mode, "mesh": "16x16",
        "label": label, "chips": 256,
        "flops_per_device": out["flops"],
        "bytes_per_device": out["bytes"],
        "collective_bytes_per_device": out["coll"],
        "model_flops_global": mf,
        "model_flops_per_device": mf / 256,
        "probe_points": points,
        "hardware": dataclasses.asdict(hw),
    }
    rec.update(roofline_terms(rec, hw))
    if verbose:
        print(f"[roofline] {arch} × {shape}: "
              f"compute={rec['compute_sec']:.4f}s "
              f"memory={rec['memory_sec']:.4f}s "
              f"collective={rec['collective_sec']:.4f}s "
              f"→ {rec['bottleneck']} "
              f"(useful-compute ratio {rec['model_flops_ratio']:.2f})")
    return rec


def roofline_terms(rec: dict, hw: Hardware = H100_SXM5) -> dict:
    """The three terms of a record at ``hw``'s figures, the bottleneck,
    the useful-compute ratio and the roofline fraction."""
    compute = rec["flops_per_device"] / hw.peak_flops_bf16
    memory = rec["bytes_per_device"] / hw.hbm_bytes_per_s
    coll = rec["collective_bytes_per_device"] / hw.link_bytes_per_s
    terms = {"compute_sec": compute, "memory_sec": memory,
             "collective_sec": coll}
    bottleneck = max(terms, key=terms.get)
    step = max(compute, memory, coll)
    useful = rec["model_flops_per_device"] / hw.peak_flops_bf16
    return {
        **terms,
        "bottleneck": bottleneck.replace("_sec", ""),
        "model_flops_ratio": (rec["model_flops_per_device"] /
                              max(rec["flops_per_device"], 1.0)),
        "roofline_fraction": useful / max(step, 1e-12),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(cfgs.ARCHS))
    ap.add_argument("--shape", choices=list(cfgs.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/roofline.jsonl")
    ap.add_argument("--peak-flops", type=float,
                    default=H100_SXM5.peak_flops_bf16,
                    help="dense bf16 FLOP/s per chip")
    ap.add_argument("--hbm-bw", type=float,
                    default=H100_SXM5.hbm_bytes_per_s,
                    help="device-memory bytes/s per chip")
    ap.add_argument("--link-bw", type=float,
                    default=H100_SXM5.link_bytes_per_s,
                    help="collective bytes/s leaving one chip")
    args = ap.parse_args(argv)
    hw = Hardware(H100_SXM5.name if (
        args.peak_flops, args.hbm_bw, args.link_bw) == (
        H100_SXM5.peak_flops_bf16, H100_SXM5.hbm_bytes_per_s,
        H100_SXM5.link_bytes_per_s) else "custom",
        args.peak_flops, args.hbm_bw, args.link_bw)

    if args.all:
        cells = [(a, s) for a in cfgs.ARCHS for s in cfgs.SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]
    if args.out and os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    failures = 0
    for arch, shape in cells:
        ok, reason = cfgs.cell_applicable(arch, shape)
        if not ok:
            rec = {"arch": arch, "shape": shape, "status": "SKIP",
                   "reason": reason}
        else:
            try:
                t0 = time.time()
                rec = probe_cell(arch, shape, hw=hw)
                rec["status"] = "OK"
                rec["probe_sec"] = round(time.time() - t0, 1)
            except Exception as e:  # a failure here is a fault of the port
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "status": "FAIL",
                       "error": f"{type(e).__name__}: {e}"}
                failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
