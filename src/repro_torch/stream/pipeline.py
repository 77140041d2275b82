"""Host-side input pipeline: prefetch, double buffering, window assembly.

Counterpart of the reference's ``stream/pipeline.py``: the training
integration of StreamApprox turns an aggregator's record stream into
training windows — candidate sequences stratified by domain id — for a
train step that samples them with OASRS on the device.

``Prefetcher`` overlaps the generation of window ``e+1`` with the
consumer's work on window ``e``. On the card, a fetch that makes its
tensors from the worker thread enqueues them on the default stream: it
overlaps the consumer's host work, not its device work.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Callable, Iterator, Optional

import torch

from repro_torch import prng
from repro_torch.stream.aggregator import StreamAggregator
from repro_torch.utils import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TokenWindowSpec:
    """Shape of one training window of candidate sequences."""
    window_sequences: int     # candidate sequences arriving per window
    seq_len: int
    num_domains: int          # strata
    vocab_size: int


def _zipf(n: int, power: Optional[float], dev) -> torch.Tensor:
    """Normalised ``1 / r**power`` over ranks ``1..n`` (f32): the power
    by ``prng.xla_pow`` (the reference's f32 ``pow``), summed in the
    reference's order (``prng.xla_sum``); bit for bit the reference's
    weights."""
    r = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    w = 1.0 / (r if power is None else prng.xla_pow(r, power))
    return w / prng.xla_sum(w)


def synthetic_token_window(spec: TokenWindowSpec, epoch: int,
                           seed: int = 0, device: DeviceLike = None):
    """Deterministic synthetic LM window: ``(tokens [W, L] i32,
    domain_ids [W] i32)``. Domains follow a Zipf mixture over ranks and
    tokens a Zipf(1.1) unigram law, so stratification matters and a
    smoke training run can learn the marginals."""
    dev = resolve_device(device)
    key = prng.fold_in(prng.PRNGKey(seed, device=dev), epoch)
    keys = prng.split(key)
    domains = prng.choice(keys[0], spec.num_domains,
                          (spec.window_sequences,),
                          _zipf(spec.num_domains, None, dev))
    tokens = prng.choice(keys[1], spec.vocab_size,
                         (spec.window_sequences, spec.seq_len),
                         _zipf(spec.vocab_size, 1.1, dev))
    return tokens.to(torch.int32), domains.to(torch.int32)


class Prefetcher:
    """Background-thread prefetch of window construction.

    ``fetch(e)`` must be a pure function of the epoch. The buffer holds
    ``depth`` windows; the epoch cursor is part of a checkpoint for exact
    resume. A fetch that fails in the background thread is raised by the
    next :meth:`next`, and the cursor never passes the failed epoch, so
    calling :meth:`next` again retries it. :meth:`close` waits for the
    fill in flight (a daemon thread still inside a torch call when the
    interpreter exits can abort it).
    """

    def __init__(self, fetch: Callable[[int], object], start_epoch: int = 0,
                 depth: int = 2):
        self._fetch = fetch
        self._epoch = start_epoch
        self._depth = depth
        self._buf: collections.deque = collections.deque()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None
        self._threads: list = []
        self._fill()

    def _fill(self):
        while len(self._buf) < self._depth:
            e = self._epoch
            item = self._fetch(e)    # may raise: the cursor is not yet
            self._epoch = e + 1      # advanced, so a retry re-fetches e
            self._buf.append((e, item))

    def next(self):
        with self._lock:
            if self._error is not None:
                # A background fill died: raise its exception here rather
                # than stall. The slot is cleared and the cursor never
                # passed the failed fetch, so next() again retries it.
                exc, self._error = self._error, None
                raise exc
            if not self._buf:        # the consumer outpaced the fill
                self._fill()
            epoch, item = self._buf.popleft()
            t = threading.Thread(target=self._fill_one, daemon=True)
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
            t.start()
            return epoch, item

    def close(self, timeout: Optional[float] = None) -> bool:
        """Wait for the background fills in flight; True when none is
        left running."""
        for t in self._threads:
            t.join(timeout)
        return not any(t.is_alive() for t in self._threads)

    def _fill_one(self):
        with self._lock:
            try:
                self._fill()
            except BaseException as exc:     # noqa: BLE001 — kept for
                self._error = exc            # next(), not lost in a thread

    @property
    def cursor(self) -> int:
        """Next epoch to be generated — checkpoint this for exact resume."""
        return self._epoch - len(self._buf)


def stream_windows(aggregator: StreamAggregator, items_per_window: int,
                   num_windows: int, start_epoch: int = 0) -> Iterator:
    """Sequential ``(epoch, chunk)`` windows of an aggregator."""
    for e in range(start_epoch, start_epoch + num_windows):
        yield e, aggregator.interval_chunk(e, items_per_window)
