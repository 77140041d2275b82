"""Batched serving with StreamApprox telemetry.

Counterpart of the reference's ``serve/serve_step.py``. :class:`Server`
wraps prefill/decode for an arch and keeps an OASRS state over
per-request telemetry records (stratum = tenant id, value = the decode
step's latency). Telemetry queries return windowed approximate aggregates
with error bounds without scanning every request: the paper's analytics
applied to the serving plane. On the card each decode step's records are
one call of the reservoir-fold kernel and each telemetry query one call
of the stratified-stats kernel (``kernels/ops``).

As the reference's, the server prefills with ``max_len=0``: the cache
holds exactly the prompt, and every decode step rewrites its last slot
(``models/kvcache.write_slot``).
"""
from __future__ import annotations

import time

import torch

from repro_torch import prng
from repro_torch.core import error, oasrs, query
from repro_torch.models import api
from repro_torch.models.config import ModelConfig
from repro_torch.utils import DeviceLike, resolve_device


class Server:
    def __init__(self, cfg: ModelConfig, params, num_tenants: int = 8,
                 telemetry_capacity: int = 256, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        where = params["embed"]["tokens"].device
        if where.type != self.device.type:
            raise ValueError(f"params are on {where}, the server on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self._prefill = api.prefill_fn(cfg)
        self._decode = api.decode_fn(cfg)
        self.telemetry = oasrs.init(
            num_tenants, telemetry_capacity, prng.PRNGKey(seed),
            device=self.device)

    def prefill(self, batch: dict):
        with torch.inference_mode():
            return self._prefill(self.params, batch, max_len=0)

    def decode(self, state, tokens: torch.Tensor, tenant_ids=None):
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, state = self._decode(self.params, state, tokens)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = (time.perf_counter() - t0) * 1e3
        if tenant_ids is not None:
            # The host's latency rounded to f32, as jnp.full rounds it.
            lat = torch.full((tokens.shape[0],), dt, dtype=torch.float32,
                             device=self.device)
            self.telemetry = oasrs.update_chunk(self.telemetry, tenant_ids,
                                                lat)
        return logits, state

    def generate(self, batch: dict, steps: int, tenant_ids=None):
        logits, state = self.prefill(batch)
        toks = _next_tokens(logits)
        out = [toks]
        for _ in range(steps):
            logits, state = self.decode(state, toks, tenant_ids)
            toks = _next_tokens(logits)
            out.append(toks)
        return torch.cat(out, dim=1)

    def telemetry_mean(self) -> error.Estimate:
        """Approximate mean decode latency per window, with error bound."""
        return query.query_mean(self.telemetry)

    def telemetry_per_tenant(self) -> error.Estimate:
        return query.group_means(self.telemetry)

    def metrics_text(self) -> str:
        """Prometheus text of the serving-plane telemetry: windowed
        decode-latency estimates with their 95% half-widths (per tenant,
        labelled by index). Reads the estimates back: a scrape is a sync
        point."""
        from repro_torch.obs.export import estimates_prometheus_text
        return estimates_prometheus_text({
            "decode_latency_ms": self.telemetry_mean(),
            "tenant_decode_latency_ms": self.telemetry_per_tenant(),
        })

    def new_window(self):
        self.telemetry = oasrs.reset_window(self.telemetry)


def _next_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next tokens ``[B, 1]`` int32 (the reference's argmax dtype;
    ties go to the first index in both)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
