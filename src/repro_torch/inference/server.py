"""Batched forest serving — the forest half of ``repro.inference.server``.

  * ``MicroBatcher`` — groups incoming requests into engine-shaped batches
    under a max-latency budget (dispatch when ``max_batch`` is reached OR
    the oldest request exceeds ``max_wait_ms``).
  * ``ForestServer`` — tree-ensemble scoring behind a micro-batcher, on
    any ``repro_torch.core`` predictor (``backend="torch"`` or the CUDA
    kernel).

Requests are processed in arrival order; the batcher is deterministic given
arrival timestamps, so tests can assert exact batching decisions.  Default
clocks are ``time.perf_counter()`` (monotonic); callers may pass explicit
``arrival_s`` / ``now_s`` values (virtual clocks), since the server only
ever subtracts timestamps.

Not yet ported: ``ForestServer.from_forest`` (the autotuner), ``save`` /
``load`` (``io``), ``obs=`` (``obs``) and ``LMServer`` (the LM slice); each
raises ``NotImplementedError``.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch


# --------------------------------------------------------------------------- #
# Requests / stats
# --------------------------------------------------------------------------- #
@dataclass
class Request:
    rid: int
    payload: Any                      # (d,) features | (S,) prompt tokens
    arrival_s: float
    done_s: Optional[float] = None
    result: Any = None

    @property
    def latency_ms(self) -> Optional[float]:
        if self.done_s is None:
            return None
        return (self.done_s - self.arrival_s) * 1e3


class Reservoir:
    """Bounded sample of a value stream: exact below ``cap``, a uniform
    random sample above (Vitter's Algorithm R, deterministic seed), with
    the running count and sum kept exactly so ``mean()`` is always exact
    while percentiles come from the retained sample.

    This replaces the unbounded ``ServerStats`` lists: a server under
    sustained traffic holds O(cap) floats no matter how many requests it
    has completed, and ``summary()`` percentiles stay O(cap) work.
    Below the cap the sample IS the full stream, so short runs (every
    test, every benchmark window) lose nothing.
    """

    __slots__ = ("cap", "n", "total", "_sample", "_rng")

    def __init__(self, cap: int = 4096, seed: int = 0):
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.cap = cap
        self.n = 0                       # values ever observed (exact)
        self.total = 0.0                 # running sum (exact mean)
        self._sample: list[float] = []
        self._rng = random.Random(seed)

    def append(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.total += v
        if len(self._sample) < self.cap:
            self._sample.append(v)
        else:
            # Algorithm R: keep each of the n values with prob cap/n
            j = self._rng.randrange(self.n)
            if j < self.cap:
                self._sample[j] = v

    def extend(self, it) -> None:
        for v in it:
            self.append(v)

    def mean(self) -> float:
        return self.total / self.n if self.n else 0.0

    def percentile(self, q) -> float:
        if not self._sample:
            raise ValueError("percentile of an empty reservoir")
        return float(np.percentile(self._sample, q))

    # list-compatible surface: existing callers iterate, truth-test,
    # np.asarray, and compare against plain lists
    def __len__(self) -> int:
        return len(self._sample)

    def __iter__(self):
        return iter(self._sample)

    def __bool__(self) -> bool:
        return self.n > 0

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._sample, dtype=dtype)

    def __eq__(self, other):
        if isinstance(other, Reservoir):
            return self._sample == other._sample and self.n == other.n
        if isinstance(other, (list, tuple)):
            return self._sample == list(other)
        return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return (f"Reservoir(n={self.n}, cap={self.cap}, "
                f"retained={len(self._sample)})")


@dataclass
class ServerStats:
    n_requests: int = 0
    n_batches: int = 0
    batch_sizes: Reservoir = field(default_factory=Reservoir)
    latencies_ms: Reservoir = field(default_factory=Reservoir)
    # per-batch phase breakdown: device compute (predict dispatch) vs
    # host sync (device synchronize + copy-out)
    compute_ms: Reservoir = field(default_factory=Reservoir)
    sync_ms: Reservoir = field(default_factory=Reservoir)

    def record_batch(self, reqs: list[Request]) -> None:
        if not reqs:                   # zero-request batch: stats unchanged
            return
        self.n_batches += 1
        self.n_requests += len(reqs)
        self.batch_sizes.append(len(reqs))
        self.latencies_ms.extend(
            r.latency_ms for r in reqs if r.latency_ms is not None)

    def record_phases(self, compute_ms: float, sync_ms: float) -> None:
        """Record one batch's device-compute / host-sync split."""
        self.compute_ms.append(compute_ms)
        self.sync_ms.append(sync_ms)

    def summary(self) -> dict:
        # no completed request → no latency distribution: report null,
        # not the 0.0 percentiles of a zeros(1) placeholder (a dashboard
        # reading p99=0.0 would conclude the server is infinitely fast)
        lat = self.latencies_ms if self.latencies_ms else None
        out = {
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "mean_batch": self.batch_sizes.mean(),
            "p50_ms": lat.percentile(50) if lat is not None else None,
            "p99_ms": lat.percentile(99) if lat is not None else None,
        }
        if self.compute_ms:
            out["compute_p50_ms"] = self.compute_ms.percentile(50)
            out["sync_p50_ms"] = self.sync_ms.percentile(50) \
                if self.sync_ms else None
        return out


# --------------------------------------------------------------------------- #
# Micro-batcher
# --------------------------------------------------------------------------- #
class MicroBatcher:
    """Dispatch rule: flush when ``len(queue) >= max_batch`` or when
    ``now - oldest.arrival_s >= max_wait_ms``. Pure decision logic —
    unit-testable without a clock."""

    def __init__(self, max_batch: int = 64, max_wait_ms: float = 5.0):
        if max_batch < 1:
            # drain() would emit empty batches forever (flush() spins)
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.queue: list[Request] = []

    def add(self, req: Request) -> None:
        self.queue.append(req)

    def ready(self, now_s: float) -> bool:
        if not self.queue:
            return False
        if len(self.queue) >= self.max_batch:
            return True
        return (now_s - self.queue[0].arrival_s) * 1e3 >= self.max_wait_ms

    def drain(self) -> list[Request]:
        batch, self.queue = (self.queue[:self.max_batch],
                             self.queue[self.max_batch:])
        return batch


# --------------------------------------------------------------------------- #
# Forest serving
# --------------------------------------------------------------------------- #
class ForestServer:
    def __init__(self, predictor, max_batch: int = 256,
                 max_wait_ms: float = 2.0, *, obs=None):
        if obs is not None and obs is not False:
            raise NotImplementedError(
                "obs= needs repro_torch.obs, ported in the serving-runtime "
                "slice (ROADMAP Queue A item 9)")
        self.predictor = predictor
        self.batcher = MicroBatcher(max_batch, max_wait_ms)
        self.stats = ServerStats()
        self._rid = 0

    @classmethod
    def from_forest(cls, forest, **kw) -> "ForestServer":
        raise NotImplementedError(
            "ForestServer.from_forest needs the autotuner, ported in the "
            "autotuner slice (ROADMAP Queue A item 8); build a predictor "
            "with core.compile_forest and pass it to ForestServer")

    def save(self, path) -> None:
        raise NotImplementedError(
            "ForestServer.save needs repro_torch.io, ported in the "
            "ingestion slice (ROADMAP Queue A item 6)")

    @classmethod
    def load(cls, path) -> "ForestServer":
        raise NotImplementedError(
            "ForestServer.load needs repro_torch.io, ported in the "
            "ingestion slice (ROADMAP Queue A item 6)")

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Normalized class scores (paper §4) from the serving engine —
        synchronous path, bypasses the micro-batcher."""
        return self.predictor.predict_proba(X)

    def submit(self, features: np.ndarray,
               arrival_s: Optional[float] = None) -> Request:
        self._rid += 1
        req = Request(self._rid, np.asarray(features),
                      arrival_s if arrival_s is not None
                      else time.perf_counter())
        self.batcher.add(req)
        return req

    def poll(self, now_s: Optional[float] = None) -> list[Request]:
        """Flush if the dispatch rule fires; returns completed requests."""
        now = now_s if now_s is not None else time.perf_counter()
        if not self.batcher.ready(now):
            return []
        return self._run(self.batcher.drain(), now)

    def flush(self, now_s: Optional[float] = None) -> list[Request]:
        """Unconditional drain (shutdown path)."""
        done = []
        now = now_s if now_s is not None else time.perf_counter()
        while self.batcher.queue:
            done.extend(self._run(self.batcher.drain(), now))
        return done

    def _run(self, reqs: list[Request], now_s: float) -> list[Request]:
        if not reqs:                   # empty flush/drain: no-op, no stats
            return []
        X = np.stack([r.payload for r in reqs])
        t0 = time.perf_counter()
        scores = self.predictor.predict(X)
        t_compute = time.perf_counter()
        # a predictor that returns a tensor on the card has only launched
        # its work: wait for it before stamping done_s, or the recorded
        # latency understates reality (numpy results are already host-side)
        if isinstance(scores, torch.Tensor) and scores.is_cuda:
            torch.cuda.synchronize(scores.device)
        t_sync = time.perf_counter()
        # completion on the caller's clock: virtual arrival time + real
        # compute time (keeps latency stats consistent under virtual clocks)
        done_s = (now_s if now_s is not None else t0) + (t_sync - t0)
        for r, s in zip(reqs, scores):
            r.result = s
            r.done_s = done_s
        self.stats.record_batch(reqs)
        self.stats.record_phases((t_compute - t0) * 1e3,
                                 (t_sync - t_compute) * 1e3)
        return reqs


class LMServer:
    """LM prefill + decode serving — waits for the LM slice of the port."""

    def __init__(self, *args, **kw):
        raise NotImplementedError(
            "LMServer waits for the LM slice of the port (ROADMAP Queue A "
            "item 12)")
