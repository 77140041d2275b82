"""Serving CLI: batched generation + approximate telemetry.

Counterpart of the reference's ``launch/serve.py``, with its flags and
its output line, plus ``--device`` (the card unless ``--device cpu``).
As the reference's, ``--smoke`` is a ``store_true`` flag that defaults
to True, so this CLI always runs the smoke-width config in f32; the
full-width path is driven through :class:`~repro_torch.serve.serve_step.
Server` (``chip_smoke.py``, phase ``serve``).

Usage (CPU-scale demo):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi4-mini-3.8b \\
      --smoke --requests 8 --steps 16 --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs as cfgs
from repro_torch import prng
from repro_torch.models import api
from repro_torch.models.param import init_params
from repro_torch.serve.serve_step import Server
from repro_torch.utils import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b",
                    choices=list(cfgs.ARCHS))
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = cfgs.get_config(args.arch, smoke=args.smoke).replace(
        dtype=torch.float32)
    params = init_params(api.skeleton(cfg), prng.PRNGKey(0), device=dev)
    server = Server(cfg, params, num_tenants=args.tenants, device=dev)

    key = prng.PRNGKey(1, device=dev)
    batch = {"tokens": prng.randint(
        key, (args.requests, args.prompt_len), 0, cfg.vocab_size)}
    if cfg.family == "encdec":
        batch["frames"] = prng.normal(
            prng.fold_in(key, 1),
            (args.requests, args.prompt_len, cfg.d_model))
    if cfg.family == "vlm":
        batch["patches"] = prng.normal(
            prng.fold_in(key, 2),
            (args.requests, cfg.num_patches, cfg.d_model))
    tenants = prng.randint(prng.fold_in(key, 3), (args.requests,), 0,
                           args.tenants)
    out = server.generate(batch, steps=args.steps, tenant_ids=tenants)
    est = server.telemetry_mean()
    print(f"[serve] generated {tuple(out.shape)} tokens; "
          f"mean decode latency {float(est.value):.2f} "
          f"± {float(est.error_bound(0.95)):.2f} ms (95% CI, sampled)")
    return 0


if __name__ == "__main__":
    main()
