"""Serving with approximate telemetry (DESIGN.md §3.3), on the port.

The PyTorch/CUDA counterpart of ``examples/serve_telemetry.py``: serves
batched requests on a smoke-scale model while OASRS samples per-request
decode-latency records stratified by tenant; windowed telemetry queries
return mean latency (global + per tenant) with 95% bounds without
retaining every record. Runs on the card unless ``--device cpu``;
``--prompt-len`` sets each request's prompt (the reference's 32 by
default).

Run:  PYTHONPATH=src python examples/torch_serve_telemetry.py --device cpu
"""
import os
import sys
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import argparse

import torch

from repro_torch import configs as cfgs
from repro_torch import prng
from repro_torch.models import api
from repro_torch.models.param import init_params
from repro_torch.serve.serve_step import Server
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfgs.get_config("phi4-mini-3.8b", smoke=True).replace(
        dtype=torch.float32)
    params = init_params(api.skeleton(cfg), prng.PRNGKey(0), device=dev)
    server = Server(cfg, params, num_tenants=4, telemetry_capacity=64,
                    device=dev)

    B, S = 4, args.prompt_len
    for window_i in range(3):
        server.new_window()
        for req in range(5):
            key = prng.fold_in(prng.PRNGKey(1, device=dev),
                               window_i * 10 + req)
            batch = {"tokens": prng.randint(key, (B, S), 0,
                                            cfg.vocab_size)}
            tenants = prng.randint(prng.fold_in(key, 1), (B,), 0, 4)
            out = server.generate(batch, steps=4, tenant_ids=tenants)
        est = server.telemetry_mean()
        per = server.telemetry_per_tenant()
        print(f"window {window_i}: mean decode latency "
              f"{float(est.value):.2f} ± "
              f"{float(est.error_bound(0.95)):.2f} ms   per-tenant: "
              + " ".join(f"t{t}={float(per.value[t]):.1f}ms"
                         for t in range(4)))
    print("generated shape:", tuple(out.shape))
    print("\n--- /metrics (Prometheus text exposition) ---")
    print(server.metrics_text(), end="")


if __name__ == "__main__":
    main()
