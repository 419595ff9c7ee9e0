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

  * ``LMServer`` — batch LM completion over ``repro_torch.models.Model``:
    one trunk pass fills the KV cache from the prompt, then greedy decode.

``ForestServer.save`` / ``load`` persist a serving artifact through
``repro_torch.io``.  Not yet ported: ``ForestServer.from_forest`` (the
autotuner), ``obs=`` (``obs``) and ``LMServer(kv_quant=True)`` (the int8 KV
cache); each raises ``NotImplementedError``.
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
    # cascade serving: cumulative per-stage exit counts (empty unless the
    # predictor reports them — see ForestServer._run)
    stage_exit_counts: list = field(default_factory=list)

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

    def record_exits(self, counts) -> None:
        """Accumulate a cascade predictor's per-stage exit counts for the
        batch just served (``counts`` is its ``last_exit_counts``)."""
        if counts is None:
            return
        counts = [int(c) for c in counts]
        if len(self.stage_exit_counts) < len(counts):
            self.stage_exit_counts.extend(
                [0] * (len(counts) - len(self.stage_exit_counts)))
        for i, c in enumerate(counts):
            self.stage_exit_counts[i] += c

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
        if self.stage_exit_counts:
            tot = sum(self.stage_exit_counts)
            out["exit_fractions"] = [c / max(tot, 1)
                                     for c in self.stage_exit_counts]
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
        self.engine_choice = None          # the engine's name after load()

    @classmethod
    def from_forest(cls, forest, **kw) -> "ForestServer":
        raise NotImplementedError(
            "ForestServer.from_forest needs the autotuner, ported in the "
            "autotuner slice (ROADMAP Queue A item 8); build a predictor "
            "with core.compile_forest and pass it to ForestServer")

    def save(self, path) -> None:
        """Persist the compiled serving artifact (docs/FORMATS.md): the
        engine's buffers + the serving config, so a cold restart skips
        recompilation.  The predictor must come from a serializable engine
        (``EngineSpec.serial_arrays``: the ``torch`` engines; a ``cuda``
        predictor raises ``ValueError`` — keep the forest and recompile).
        Cascade predictors persist as kind=cascade artifacts."""
        from .. import io
        # engine_choice is a bare name string after load(): persist it
        # through a load → save cycle
        extra = {"server": {"max_batch": self.batcher.max_batch,
                            "max_wait_ms": self.batcher.max_wait_ms,
                            "engine_choice": getattr(self.engine_choice,
                                                     "engine",
                                                     self.engine_choice)}}
        io.save_predictor(self.predictor, path, extra=extra)

    @classmethod
    def load(cls, path, device=None) -> "ForestServer":
        """Cold-start a server from a ``save()`` artifact (or one the
        reference wrote) on ``device`` (``None`` → the card): predictions
        are bit-identical to the saved predictor's, no recompile.
        ``engine_choice`` is the saved engine's *name*."""
        from .. import io
        pred, header = io.load_predictor(path, device=device,
                                         return_header=True)
        scfg = header.get("server") or {}
        srv = cls(pred, max_batch=int(scfg.get("max_batch", 256)),
                  max_wait_ms=float(scfg.get("max_wait_ms", 2.0)))
        srv.engine_choice = scfg.get("engine_choice")
        return srv

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
        # cascade predictors report which stage each row exited at
        self.stats.record_exits(getattr(self.predictor, "last_exit_counts",
                                        None))
        return reqs


class LMServer:
    """Batch LM text completion over the port's ``Model``.  Greedy decode.

    The reference prefills by teacher-forcing the prompt through S decode
    steps (``repro/inference/server.py:431-448``).  Here the prefill is
    one trunk pass over the prompt (``Model.prefill`` with the decode
    state): every attention layer writes its post-RoPE K and V into cache
    positions 0..S-1 in the cache's dtype and attends over them as
    stored, ``index`` becomes S, and the last position's logits come back
    as f32 — what the reference's sequential prefill returns, up to
    rounding.  On ``backend="cuda"`` that pass runs the flash kernel once
    per attention layer.  Decode then runs ``Model.decode_step`` once per
    new token, as the reference.

    The params are cast to the model's compute dtype once, here.  The KV
    cache is bf16, the reference's default, whatever the compute dtype.
    ``last_times`` holds the host-clock milliseconds of the last
    ``generate``'s prefill and decode, each ended by a device sync.
    """

    def __init__(self, model, params, *, batch: int, max_len: int,
                 kv_quant: bool = False):
        if kv_quant:
            raise NotImplementedError(
                "LMServer(kv_quant=True): the int8 KV cache waits for a "
                "later slice of the port (ROADMAP Queue A 12)")
        self.model = model
        self.params = model.cast(params)
        self.batch = batch
        self.max_len = max_len
        self.last_times: dict = {}

    def _sync(self) -> None:
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)

    def _prefill(self, state: dict, tokens) -> tuple[dict, torch.Tensor]:
        """Fill ``state``'s cache from ``tokens`` (B, S) in one pass →
        (state, last-position logits (B, vocab) f32)."""
        logits = self.model.prefill(self.params, tokens, state)
        return state, logits.float()

    def generate(self, prompts: np.ndarray, n_new: int) -> np.ndarray:
        """prompts (B, S) int32 → (B, S + n_new) completed greedily (the
        first maximum on ties, as ``jnp.argmax``)."""
        B, S = prompts.shape
        if B != self.batch or S + n_new > self.max_len:
            raise ValueError(f"prompts {prompts.shape} and {n_new} new "
                             f"tokens for batch {self.batch}, max_len "
                             f"{self.max_len}")
        with torch.inference_mode():
            state = self.model.init_decode_state(B, self.max_len,
                                                 params=self.params)
            t0 = time.perf_counter()
            state, logits = self._prefill(state, prompts)
            tok = torch.argmax(logits, dim=-1)
            self._sync()
            t1 = time.perf_counter()
            new = []
            for _ in range(n_new):
                new.append(tok)
                logits, state = self.model.decode_step(
                    self.params, state, tok[:, None])
                tok = torch.argmax(logits.float(), dim=-1)
            self._sync()
            t2 = time.perf_counter()
        self.last_times = {"prefill_ms": (t1 - t0) * 1e3,
                           "decode_ms": (t2 - t1) * 1e3, "n_decode": n_new}
        out = [np.asarray(prompts, dtype=np.int32)]
        if new:
            out.append(torch.stack(new, dim=1).cpu().numpy().astype(np.int32))
        return np.concatenate(out, axis=1)
