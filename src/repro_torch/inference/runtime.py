"""Concurrent multi-tenant serving runtime — the production front door; the
port's counterpart of ``repro.inference.runtime``.

``ForestServer`` is a synchronous submit/poll loop around one predictor:
correct, deterministic, and exactly what benchmarks and tests want — but
a real deployment has concurrent callers, several models hot at once,
a latency SLO, and no tolerance for a first request that pays a first-use
cost on the card.  ``ServingRuntime`` turns the existing parts
(``MicroBatcher``, ``ServerStats``, packed artifacts, the autotuner) into
that front door:

  * **Threaded request loop** — ``submit(model_id, x)`` is thread-safe
    and returns a future-backed ``ServedRequest``; a single worker
    thread drains the lock-guarded per-tenant queues into batches when
    the dispatch rule fires.  Every request is completed exactly once —
    including on shutdown, where ``close()`` flushes all queues before
    the worker exits (no request is ever dropped or double-resolved).
  * **Multi-model tenancy** — N forests hot in one process, routed by
    model id.  Tenants share the process-wide engine/autotune cache
    (``from_forests`` sweeps through ``core.engine_select.choose``) and
    cold-start from packed ``.repro.npz`` artifacts via a JSON manifest
    (``save``/``load``, ``io.packed.save_manifest``).
  * **SLO-aware adaptive batching** — ``SLOConfig(target_p99_ms=...)``
    attaches an ``AdaptiveBatchController`` per tenant: the observed
    p99 over a sliding window grows or shrinks the *effective*
    ``max_batch``/``max_wait_ms`` multiplicatively, always clamped to
    the configured bounds.  The controller is a pure function of the
    observed latency sequence — no internal clock — so it is
    deterministic under the virtual-clock test contract.
  * **Shape warmup** — ``warmup()`` runs every power-of-two batch bucket
    a tenant can be served at (``core.engine_select.bucket_ladder``),
    including the kernel predictors' and the fused cascade's internally
    bucketed shapes, so no live request meets a shape the predictor has
    not run (``repro_torch.obs.retrace``: allocator growth, lazy kernel
    load, per-shape layouts).  Dispatch pads plain-engine batches to the
    same buckets (row-independent engines: the padded rows change
    nothing), so the warmed shapes are the *only* shapes the engines
    ever see.  Kernel predictors (``block_b``) and cascades
    (``last_exit_counts``) bucket internally and are not padded, so one
    live batch is exactly one kernel launch.

What the card changes against the reference:

  * **The syncs.**  Where the reference calls ``jax.block_until_ready``
    (warmup and dispatch), the port calls ``torch.cuda.synchronize`` when
    a tensor on the card comes back.  Every port predictor returns host
    numpy, so the wait for the device falls inside ``compute_ms`` and
    ``sync_ms`` reads ≈ 0 (as in ``ForestServer._run``).
  * **The worker thread launches kernels.**  The wrappers launch on the
    calling thread's current stream of the operands' device; warmup runs
    in the caller's thread and live batches in the worker, so each batch
    runs inside ``torch.cuda.device(<the tenant's card>)``.
  * **A batch that raises** (a kernel launch error included) resolves its
    futures with the exception, counts in ``repro_request_errors_total``,
    and the worker lives on.  Nothing is sent through a plain version.

Two execution modes share all of the above:

  * ``start()``/``close()`` — the background worker thread on the real
    (monotonic) clock; production and load tests.
  * ``pump(now_s)``/``flush(now_s)`` — manual dispatch on a caller
    clock; deterministic tests drive virtual time through the same
    batching, stats, and controller code the thread runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import re
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from ..core.engine_select import bucket_batch, bucket_ladder
from ..obs.log import get_logger
from ..obs.metrics import MetricsRegistry, get_registry
from ..obs.retrace import CompileWatch
from ..obs.serving import ServingMetrics
from ..obs.trace import Span
from .server import MicroBatcher, Request, ServerStats

_LOG = get_logger("serving")


# --------------------------------------------------------------------------- #
# SLO-aware adaptive batching
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class SLOConfig:
    """Latency budget + controller bounds for one tenant.

    ``target_p99_ms`` is the budget; the controller keeps the effective
    ``max_batch``/``max_wait_ms`` inside ``[min_batch, max_batch]`` ×
    ``[min_wait_ms, max_wait_ms]`` (``None`` bounds default to the
    tenant's configured values at attach time).  ``window`` completed
    requests feed one control decision; ``headroom`` is the fraction of
    the budget below which the controller grows (between ``headroom *
    target`` and ``target`` it holds, avoiding oscillation around the
    budget)."""
    target_p99_ms: float
    window: int = 64
    min_batch: int = 1
    max_batch: Optional[int] = None
    min_wait_ms: float = 0.0
    max_wait_ms: Optional[float] = None
    grow: float = 1.25
    shrink: float = 0.5
    headroom: float = 0.7

    def to_header(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_header(cls, d: dict) -> "SLOConfig":
        return cls(**d)


class AdaptiveBatchController:
    """Bounded grow/shrink controller over (max_batch, max_wait_ms).

    Feed it every completed request's latency via ``observe``; each full
    window of ``slo.window`` observations closes with one decision:

      * window p99 > target           → **shrink** both knobs (×
        ``slo.shrink``, clamped to the lower bounds) — the batcher
        dispatches sooner and smaller, trading throughput for latency;
      * window p99 < headroom·target  → **grow** both knobs (×
        ``slo.grow``, clamped to the upper bounds) — spare budget is
        spent on bigger batches;
      * otherwise                     → **hold**.

    The decision is a pure function of the observed latencies (no
    clock, no randomness), so a virtual-clock test replaying a latency
    trace gets bit-identical decisions, and the same decisions as the
    reference's controller.  The effective values can never leave the
    configured bounds."""

    #: decisions retained for inspection (bounded, like the stats)
    HISTORY = 256

    def __init__(self, slo: SLOConfig, batch: int, wait_ms: float):
        self.slo = slo
        self.min_batch = max(1, int(slo.min_batch))
        self.max_batch_bound = int(slo.max_batch if slo.max_batch
                                   is not None else batch)
        self.min_wait_ms = float(slo.min_wait_ms)
        self.max_wait_ms_bound = float(slo.max_wait_ms if slo.max_wait_ms
                                       is not None else wait_ms)
        if self.max_batch_bound < self.min_batch:
            raise ValueError(f"SLO batch bounds empty: "
                             f"[{self.min_batch}, {self.max_batch_bound}]")
        if self.max_wait_ms_bound < self.min_wait_ms:
            raise ValueError(
                f"SLO wait bounds empty: "
                f"[{self.min_wait_ms}, {self.max_wait_ms_bound}]")
        self.max_batch = self._clamp_batch(batch)
        self.max_wait_ms = self._clamp_wait(wait_ms)
        self._window: list[float] = []
        self.decisions: list[dict] = []

    def _clamp_batch(self, b) -> int:
        return int(min(max(int(b), self.min_batch), self.max_batch_bound))

    def _clamp_wait(self, w) -> float:
        return float(min(max(float(w), self.min_wait_ms),
                         self.max_wait_ms_bound))

    def observe(self, latency_ms: Optional[float]) -> Optional[dict]:
        """Record one completed latency; returns the decision record when
        this observation closes a window, else ``None``."""
        if latency_ms is None:
            return None
        self._window.append(float(latency_ms))
        if len(self._window) < self.slo.window:
            return None
        p99 = float(np.percentile(self._window, 99))
        self._window = []
        target = self.slo.target_p99_ms
        if p99 > target:
            action = "shrink"
            self.max_batch = self._clamp_batch(
                self.max_batch * self.slo.shrink)
            self.max_wait_ms = self._clamp_wait(
                self.max_wait_ms * self.slo.shrink)
        elif p99 < self.slo.headroom * target:
            action = "grow"
            # a zero wait can't grow multiplicatively — seed it with the
            # smaller of half a millisecond and the upper bound
            grown = self.max_wait_ms * self.slo.grow \
                if self.max_wait_ms > 0 \
                else min(0.5, self.max_wait_ms_bound)
            self.max_batch = self._clamp_batch(
                max(self.max_batch + 1, self.max_batch * self.slo.grow))
            self.max_wait_ms = self._clamp_wait(grown)
        else:
            action = "hold"
        rec = {"p99_ms": p99, "target_ms": target, "action": action,
               "max_batch": self.max_batch,
               "max_wait_ms": self.max_wait_ms}
        self.decisions.append(rec)
        del self.decisions[:-self.HISTORY]
        return rec


# --------------------------------------------------------------------------- #
# Requests / tenants
# --------------------------------------------------------------------------- #
@dataclass
class ServedRequest(Request):
    """A ``Request`` routed to a tenant, with a thread-safe future the
    submitting thread can block on (``wait``).  When observability is on
    the worker attaches a ``repro_torch.obs.trace.Span`` (phase
    breakdown) before resolving the future."""
    tenant: str = ""
    future: Future = field(default_factory=Future)
    span: Optional[Span] = None

    def wait(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the worker resolves this request; returns the
        score row (or re-raises the batch's exception)."""
        return self.future.result(timeout)


_MODEL_ID = re.compile(r"^[A-Za-z0-9._-]+$")


def _pads_to_bucket(pred) -> bool:
    """Whether dispatch may zero-pad this predictor's batches up to the
    power-of-two bucket.  Padding is safe exactly when the predictor is
    row-independent *and* does not account per-row statistics: cascade
    predictors count per-row exits (a padded row would pollute
    ``exit_fractions``) and bucket internally anyway; kernel predictors
    (``block_b``) bucket internally too, so one live batch stays one
    launch.  Everything else — the plain ``BasePredictor`` engines — meets
    a new shape per batch size, so padding is what makes warmup's bucket
    ladder cover every live shape."""
    if hasattr(pred, "last_exit_counts"):     # cascade: exit accounting
        return False
    if hasattr(pred, "block_b"):              # kernel: internal bucketing
        return False
    return True


def _card(pred) -> Optional[torch.device]:
    """The CUDA device a predictor computes on, or ``None``."""
    dev = getattr(pred, "device", None)
    if isinstance(dev, torch.device) and dev.type == "cuda":
        return dev
    return None


def _on_device(device: Optional[torch.device]):
    """A context that makes ``device`` current in the calling thread."""
    if device is None:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _to_host(scores) -> np.ndarray:
    """Scores as host numpy; a tensor on the card is waited for first."""
    if isinstance(scores, torch.Tensor):
        if scores.is_cuda:
            torch.cuda.synchronize(scores.device)
        return scores.cpu().numpy()
    return np.asarray(scores)


class _Tenant:
    """One hot model: predictor + batcher + stats (+ controller)."""

    def __init__(self, model_id: str, predictor, max_batch: int,
                 max_wait_ms: float, slo: Optional[SLOConfig]):
        self.model_id = model_id
        self.predictor = predictor
        self.device = _card(predictor)
        self.cfg_max_batch = int(max_batch)       # configured (manifest)
        self.cfg_max_wait_ms = float(max_wait_ms)
        self.batcher = MicroBatcher(max_batch, max_wait_ms)
        self.stats = ServerStats()
        self.controller = AdaptiveBatchController(slo, max_batch,
                                                  max_wait_ms) \
            if slo is not None else None
        if self.controller is not None:
            # start at the controller's clamped effective values
            self.batcher.max_batch = self.controller.max_batch
            self.batcher.max_wait_ms = self.controller.max_wait_ms
        self.pad_buckets = _pads_to_bucket(predictor)
        self.warmed: tuple = ()
        self.engine_choice = None                 # set by from_forests()
        self.watch: Optional[CompileWatch] = None  # set by add_model()

    @property
    def hard_max_batch(self) -> int:
        """The largest batch dispatch can ever emit — the controller's
        upper bound when adaptive (growth must never hit a cold shape),
        the configured cap otherwise.  Warmup runs up to this."""
        if self.controller is not None:
            return self.controller.max_batch_bound
        return self.batcher.max_batch

    def summary(self) -> dict:
        out = self.stats.summary()
        out["effective_max_batch"] = self.batcher.max_batch
        out["effective_max_wait_ms"] = self.batcher.max_wait_ms
        out["adaptive"] = self.controller is not None
        out["warmed_buckets"] = list(self.warmed)
        if self.controller is not None:
            c = self.controller
            actions = {"grow": 0, "shrink": 0, "hold": 0}
            for rec in c.decisions:
                actions[rec["action"]] = actions.get(rec["action"], 0) + 1
            out["controller"] = {
                "target_p99_ms": c.slo.target_p99_ms,
                "n_decisions": len(c.decisions),
                "actions": actions,
                "last_decision": c.decisions[-1] if c.decisions else None,
                "batch_bounds": [c.min_batch, c.max_batch_bound],
                "wait_ms_bounds": [c.min_wait_ms, c.max_wait_ms_bound],
            }
        if self.watch is not None:
            out["compile_events"] = self.watch.compiles_total
            out["retrace_anomalies"] = self.watch.anomalies_total
        return out


# --------------------------------------------------------------------------- #
# The runtime
# --------------------------------------------------------------------------- #
class ServingRuntime:
    """Concurrent multi-tenant serving front door (module docstring).

    ``clock`` injects the timebase for *default* timestamps (submission
    arrivals, manual ``pump``/``flush``); it defaults to the monotonic
    ``time.perf_counter``.  Explicit ``arrival_s``/``now_s`` arguments
    always win, which is the virtual-clock test contract shared with
    ``ForestServer``.

    ``obs`` wires the observability layer: ``True`` (default) instruments
    against the process-wide default registry; a ``MetricsRegistry`` or
    ``ServingMetrics`` instance instruments against that (isolated
    registries in tests); ``False``/``None`` disables instrumentation
    entirely.  Phase spans use the same timestamps the runtime already
    stamps, so virtual-clock runs stay deterministic with observability
    on."""

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 obs=True, trace_cap: int = 256):
        self._clock = clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._tenants: dict[str, _Tenant] = {}
        self._rid = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        if obs is True:
            self._obs: Optional[ServingMetrics] = ServingMetrics(
                get_registry(), trace_cap=trace_cap)
        elif isinstance(obs, ServingMetrics):
            self._obs = obs
        elif isinstance(obs, MetricsRegistry):
            self._obs = ServingMetrics(obs, trace_cap=trace_cap)
        else:
            self._obs = None
        self._metrics_server = None

    @property
    def obs(self) -> Optional[ServingMetrics]:
        """The instrumentation bundle, or ``None`` when disabled."""
        return self._obs

    # ---------------------------------------------------------- tenancy
    def add_model(self, model_id: str, predictor, *, max_batch: int = 256,
                  max_wait_ms: float = 2.0,
                  slo: Optional[SLOConfig] = None) -> None:
        """Register a hot model under ``model_id`` (any compiled
        predictor: plain engine, kernel, cascade — the ``Predictor``
        protocol).  ``slo`` attaches the adaptive batching controller."""
        if not _MODEL_ID.match(model_id):
            raise ValueError(
                f"model id {model_id!r} must match {_MODEL_ID.pattern} "
                "(it names the packed artifact on save())")
        with self._lock:
            if model_id in self._tenants:
                raise ValueError(f"model id {model_id!r} already serving")
            t = _Tenant(model_id, predictor, max_batch, max_wait_ms, slo)
            if self._obs is not None:
                t.watch = CompileWatch(predictor)
            self._tenants[model_id] = t

    @property
    def model_ids(self) -> tuple:
        return tuple(self._tenants)

    def tenant(self, model_id: str) -> _Tenant:
        try:
            return self._tenants[model_id]
        except KeyError:
            raise ValueError(f"unknown model id {model_id!r}; serving "
                             f"{sorted(self._tenants)}") from None

    @classmethod
    def from_forests(cls, forests: dict, *, max_batch: int = 256,
                     max_wait_ms: float = 2.0,
                     slo: Optional[SLOConfig] = None,
                     clock: Optional[Callable[[], float]] = None,
                     obs=True, tune: Optional[str] = None, device=None,
                     **choose_kw) -> "ServingRuntime":
        """Autotune-and-serve N forests on ``device`` (``None`` → the
        card): each tenant's engine comes from
        ``core.engine_select.choose`` — all tenants share the
        process-wide sweep cache (memory + disk), so a fleet of
        same-shaped models pays for one sweep, not N.

        ``tune="predict"`` (alias ``"-Os"``) is the fleet cold-start
        fast path: each tenant's plan comes from the learned cost model —
        one compile per tenant instead of a full sweep — falling back to
        a narrow top-k sweep per shape whose confidence is low.  Extra
        ``choose_kw`` (``engines=``, ``cache_path=``, ``cost_model=``,
        ``confidence_threshold=``, ...) pass through."""
        from ..core import engine_select
        if tune is not None:
            choose_kw.setdefault("mode", tune)
        rt = cls(clock=clock, obs=obs)
        for tid, forest in forests.items():
            choice = engine_select.choose(forest, max_batch, device=device,
                                          **choose_kw)
            rt.add_model(tid, choice.predictor, max_batch=max_batch,
                         max_wait_ms=max_wait_ms, slo=slo)
            rt.tenant(tid).engine_choice = choice
        return rt

    # ------------------------------------------------------- persistence
    def save(self, directory) -> str:
        """Persist every tenant as a packed artifact plus a JSON
        manifest (``io.packed.save_manifest``) — ``load()`` cold-starts
        the whole fleet with no sweep and no recompile, predictions
        bit-identical.  A ``cuda`` tenant raises ``ValueError``, as
        ``io.save_predictor`` does for every kernel predictor: keep its
        forest and recompile.  Returns the manifest path."""
        from .. import io
        from ..io import packed
        directory = os.fspath(directory)
        os.makedirs(directory, exist_ok=True)
        entries = {}
        for tid, t in self._tenants.items():
            fname = f"{tid}.repro.npz"
            io.save_predictor(t.predictor, os.path.join(directory, fname))
            entries[tid] = {
                "artifact": fname,
                "max_batch": t.cfg_max_batch,
                "max_wait_ms": t.cfg_max_wait_ms,
                "slo": t.controller.slo.to_header()
                if t.controller is not None else None,
            }
        return packed.save_manifest(
            os.path.join(directory, "manifest.json"), entries)

    @classmethod
    def load(cls, path, *, device=None,
             clock: Optional[Callable[[], float]] = None,
             obs=True) -> "ServingRuntime":
        """Cold-start a fleet from a ``save()`` manifest (or the
        directory holding one; the reference's manifests load too) with
        every tenant on ``device`` (``None`` → the card): the compiled
        buffers upload as saved — no autotune sweep, no recompilation —
        and serving results are bit-identical to the saved
        predictors'."""
        from .. import io
        from ..io import packed
        rt = cls(clock=clock, obs=obs)
        for tid, e in packed.load_manifest(path).items():
            pred = io.load_predictor(e["artifact"], device=device)
            slo = SLOConfig.from_header(e["slo"]) if e.get("slo") else None
            rt.add_model(tid, pred, max_batch=int(e.get("max_batch", 256)),
                         max_wait_ms=float(e.get("max_wait_ms", 2.0)),
                         slo=slo)
        return rt

    # ------------------------------------------------------------ warmup
    def warmup(self, model_id: Optional[str] = None) -> dict:
        """Run every batch bucket each tenant can be served at.

        For each tenant, runs one prediction per ``bucket_ladder``
        entry up to ``hard_max_batch`` (the adaptive controller's upper
        bound — growth must never hit a cold shape).  Because dispatch
        pads plain-engine batches to those same buckets, and the kernel
        predictors and cascades bucket internally, a warmed tenant never
        meets a new shape on a live request.  Warmup inputs are zeros —
        predictions afterwards are bit-identical — and cascade exit
        statistics are reset so synthetic warmup rows never pollute
        served exit accounting.  Returns {model_id: [buckets]}."""
        ids = [model_id] if model_id is not None else list(self._tenants)
        out = {}
        for tid in ids:
            t = self.tenant(tid)
            pred = t.predictor
            forest = getattr(pred, "host_forest", lambda: None)()
            if forest is None:
                raise ValueError(
                    f"cannot warm {tid!r}: predictor exposes no "
                    "host_forest() to derive the input width from")
            d = int(getattr(forest, "n_features_in", forest.n_features))
            ladder = bucket_ladder(t.hard_max_batch)
            X = np.zeros((ladder[-1], max(d, 1)), dtype=np.float64)
            with _on_device(t.device):
                for b in ladder:
                    _to_host(pred.predict(X[:b]))
            getattr(pred, "reset_exit_stats", lambda: None)()
            t.warmed = tuple(ladder)
            if t.watch is not None:
                # warmup's first uses were deliberate; from here on any
                # new shape is a retrace anomaly
                t.watch.mark_warm()
            out[tid] = list(ladder)
        return out

    # ------------------------------------------------------- submission
    def submit(self, model_id: str, features,
               arrival_s: Optional[float] = None) -> ServedRequest:
        """Thread-safe enqueue; returns a future-backed request the
        caller can ``wait()`` on.  Wakes the worker thread."""
        payload = np.asarray(features)
        with self._cv:
            if self._stop:
                raise RuntimeError("runtime is closed")
            t = self.tenant(model_id)
            self._rid += 1
            req = ServedRequest(self._rid, payload,
                                arrival_s if arrival_s is not None
                                else self._clock(), tenant=model_id)
            t.batcher.add(req)
            depth = len(t.batcher.queue)
            self._cv.notify()
        o = self._obs
        if o is not None and o.enabled:
            o.queue_depth.labels(tenant=model_id).set(float(depth))
        return req

    # ------------------------------------------------------ dispatching
    def _run_batch(self, t: _Tenant, reqs: list, now_s: float) -> list:
        """Evaluate one drained batch and resolve its futures — the
        ``ForestServer._run`` contract (monotonic compute timing, wait for
        the card before stamping ``done_s``, stats + exit accounting) plus
        bucket padding, the adaptive controller, and — when observability
        is on — the phase span / metric / first-use hooks.  ``done_s``
        semantics are unchanged: the instrumentation reuses the
        timestamps the dispatch path already takes."""
        if not reqs:
            return []
        o = self._obs if (self._obs is not None
                          and self._obs.enabled) else None
        t_form = time.perf_counter()
        X = np.stack([r.payload for r in reqs])
        n = len(reqs)
        bucket = n
        t0 = time.perf_counter()
        try:
            if t.pad_buckets:
                bucket = bucket_batch(n)
                if bucket > n:
                    # zero rows: row-independent traversal, sliced off
                    # before anything observable
                    Xp = np.zeros((bucket,) + X.shape[1:], dtype=X.dtype)
                    Xp[:n] = X
                    X = Xp
            t_pad = time.perf_counter()
            with _on_device(t.device):
                scores = t.predictor.predict(X)
                t_compute = time.perf_counter()
                scores = _to_host(scores)[:n]
            t_sync = time.perf_counter()
        except Exception as e:                   # noqa: BLE001 — resolve,
            err_done = now_s + (time.perf_counter() - t0)
            for r in reqs:                       # don't kill the worker
                r.done_s = err_done
            if o is not None:                    # spans before futures:
                self._observe_error(o, t, reqs, now_s, bucket, e)
            for r in reqs:
                r.future.set_exception(e)
            return reqs
        done_s = now_s + (t_sync - t0)
        for r, s in zip(reqs, scores):
            r.result = s
            r.done_s = done_s
        phases = {
            "form_ms": (t0 - t_form) * 1e3,
            "pad_ms": (t_pad - t0) * 1e3,
            "compute_ms": (t_compute - t_pad) * 1e3,
            "sync_ms": (t_sync - t_compute) * 1e3,
        }
        t.stats.record_batch(reqs)
        t.stats.record_phases(phases["compute_ms"], phases["sync_ms"])
        exits = getattr(t.predictor, "last_exit_counts", None)
        t.stats.record_exits(exits)
        decisions: list[dict] = []
        if t.controller is not None:
            for r in reqs:
                rec = t.controller.observe(r.latency_ms)
                if rec is not None:
                    decisions.append(rec)
            if decisions:
                t.batcher.max_batch = t.controller.max_batch
                t.batcher.max_wait_ms = t.controller.max_wait_ms
        if o is not None:
            self._observe_batch(o, t, reqs, now_s, bucket, phases,
                                exits, decisions)
        # resolve futures last: a caller woken by wait() observes the
        # fully-stamped request and consistent stats
        for r in reqs:
            r.future.set_result(r.result)
        return reqs

    # -------------------------------------------------- observability
    def _observe_batch(self, o: ServingMetrics, t: _Tenant, reqs: list,
                       now_s: float, bucket: int, phases: dict,
                       exits, decisions: list) -> None:
        """Feed one successful batch into the metrics + trace layer.
        Only called when observability is on; every op here is a cheap
        in-process counter/reservoir update."""
        tid = t.model_id
        n = len(reqs)
        o.batches_total.labels(tenant=tid).inc()
        o.batch_size.labels(tenant=tid).observe(float(n))
        req_ctr = o.requests_total.labels(tenant=tid)
        lat_hist = o.latency_ms.labels(tenant=tid)
        for p, v in phases.items():
            o.phase_ms.labels(tenant=tid, phase=p).observe(v)
        queue_hist = o.phase_ms.labels(tenant=tid, phase="queue_ms")
        for r in reqs:
            queue_ms = max((now_s - r.arrival_s) * 1e3, 0.0)
            req_ctr.inc()
            queue_hist.observe(queue_ms)
            lat = r.latency_ms
            if lat is not None:
                lat_hist.observe(lat)
            span = Span(rid=r.rid, tenant=tid, arrival_s=r.arrival_s,
                        batch_size=n, bucket=bucket,
                        phases={"queue_ms": queue_ms, **phases},
                        total_ms=lat)
            r.span = span
            o.traces.add(span)
        o.queue_depth.labels(tenant=tid).set(float(len(t.batcher.queue)))
        o.effective_max_batch.labels(tenant=tid).set(
            float(t.batcher.max_batch))
        o.effective_max_wait_ms.labels(tenant=tid).set(
            float(t.batcher.max_wait_ms))
        for rec in decisions:
            o.controller_decisions_total.labels(
                tenant=tid, action=rec["action"]).inc()
        if exits is not None:
            for stage, count in enumerate(exits):
                if count:
                    o.cascade_stage_exits_total.labels(
                        tenant=tid, stage=str(stage)).inc(float(count))
        if t.watch is not None:
            compiles, anomalies = t.watch.poll()
            if compiles:
                o.compile_events_total.labels(tenant=tid).inc(compiles)
            if anomalies:
                o.retrace_anomalies_total.labels(tenant=tid).inc(anomalies)
                _LOG.warning("retrace_anomaly", tenant=tid,
                             new_shapes=anomalies, batch=n, bucket=bucket)

    def _observe_error(self, o: ServingMetrics, t: _Tenant, reqs: list,
                       now_s: float, bucket: int, err: Exception) -> None:
        """The failed-batch twin of ``_observe_batch``: errored requests
        still count as completed (their futures resolve) and additionally
        increment ``repro_request_errors_total``; their spans carry
        ``ok=false`` and the exception repr."""
        tid = t.model_id
        n = len(reqs)
        o.batches_total.labels(tenant=tid).inc()
        o.batch_size.labels(tenant=tid).observe(float(n))
        for r in reqs:
            o.requests_total.labels(tenant=tid).inc()
            o.request_errors_total.labels(tenant=tid).inc()
            queue_ms = max((now_s - r.arrival_s) * 1e3, 0.0)
            span = Span(rid=r.rid, tenant=tid, arrival_s=r.arrival_s,
                        batch_size=n, bucket=bucket,
                        phases={"queue_ms": queue_ms},
                        total_ms=r.latency_ms, ok=False, error=repr(err))
            r.span = span
            o.traces.add(span)
        o.queue_depth.labels(tenant=tid).set(float(len(t.batcher.queue)))
        _LOG.error("batch_failed", tenant=tid, batch=n, error=repr(err))

    def _next_deadline(self, now: float) -> Optional[float]:
        """Seconds until the earliest queued request's wait expires."""
        deadlines = [t.batcher.queue[0].arrival_s
                     + t.batcher.max_wait_ms * 1e-3
                     for t in self._tenants.values() if t.batcher.queue]
        if not deadlines:
            return None
        return max(min(deadlines) - now, 1e-4)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while True:
                    if self._stop:
                        break
                    now = self._clock()
                    ready = [t for t in self._tenants.values()
                             if t.batcher.ready(now)]
                    if ready:
                        break
                    self._cv.wait(self._next_deadline(now))
                now = self._clock()
                if self._stop:
                    # shutdown flush: drain EVERYTHING under the lock —
                    # submit() already rejects, so after this the queues
                    # are empty forever and every request resolves once
                    batches = []
                    for t in self._tenants.values():
                        while t.batcher.queue:
                            batches.append((t, t.batcher.drain()))
                else:
                    batches = [(t, t.batcher.drain())
                               for t in self._tenants.values()
                               if t.batcher.ready(now)]
            for t, reqs in batches:
                self._run_batch(t, reqs, now)
            if self._stop:
                return

    # ---------------------------------------------------------- control
    def start(self) -> "ServingRuntime":
        """Launch the background worker (idempotent)."""
        with self._lock:
            if self._stop:
                raise RuntimeError("runtime is closed")
            if self._thread is not None and self._thread.is_alive():
                return self
            self._thread = threading.Thread(
                target=self._loop, name="repro-serving", daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Stop accepting work, flush every queue, join the worker.
        Safe to call twice; never deadlocks — the worker's shutdown
        drain happens under the same lock that gates ``submit``."""
        with self._cv:
            already = self._stop
            self._stop = True
            self._cv.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                raise RuntimeError("serving worker failed to stop "
                                   f"within {timeout}s")
        elif not already:
            # manual-mode close: complete queued work synchronously
            self._flush_locked(self._clock())
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None

    def __enter__(self) -> "ServingRuntime":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------- manual (virtual) loop
    def pump(self, now_s: Optional[float] = None) -> list:
        """Manual dispatch: run every tenant whose rule fires at
        ``now_s`` — the deterministic single-threaded twin of the worker
        loop (virtual-clock tests drive this).  Returns completed
        requests."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("pump() is the manual loop; the worker "
                               "thread is already running")
        now = now_s if now_s is not None else self._clock()
        with self._lock:
            batches = [(t, t.batcher.drain())
                       for t in self._tenants.values()
                       if t.batcher.ready(now)]
        done = []
        for t, reqs in batches:
            done.extend(self._run_batch(t, reqs, now))
        return done

    def _flush_locked(self, now: float) -> list:
        with self._lock:
            batches = []
            for t in self._tenants.values():
                while t.batcher.queue:
                    batches.append((t, t.batcher.drain()))
        done = []
        for t, reqs in batches:
            done.extend(self._run_batch(t, reqs, now))
        return done

    def flush(self, now_s: Optional[float] = None) -> list:
        """Unconditionally drain every tenant (manual mode only)."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("flush() is the manual loop; close() "
                               "flushes the threaded runtime")
        return self._flush_locked(now_s if now_s is not None
                                  else self._clock())

    # ------------------------------------------------------------- stats
    def summary(self, model_id: Optional[str] = None) -> dict:
        """Per-tenant ``ServerStats.summary()`` + effective batching
        knobs; one tenant's dict, or {model_id: dict} for the fleet."""
        if model_id is not None:
            return self.tenant(model_id).summary()
        return {tid: t.summary() for tid, t in self._tenants.items()}

    def stats(self, model_id: Optional[str] = None) -> dict:
        """``summary()`` plus the operational state an operator wants
        live: current queue depth, the controller's full (bounded)
        decision history, and the first-use watch counters.  This is the
        ``stats`` section of the metrics endpoint's ``/metrics.json``."""
        if model_id is None:
            return {tid: self.stats(tid) for tid in self._tenants}
        t = self.tenant(model_id)
        out = t.summary()
        out["queue_depth"] = len(t.batcher.queue)
        if t.controller is not None:
            out["decisions"] = list(t.controller.decisions)
        if t.watch is not None:
            out["trace_cache_observable"] = t.watch.observable
        return out

    # ------------------------------------------------------- exposition
    def serve_metrics(self, port: int = 0,
                      host: str = "127.0.0.1"):
        """Start (idempotently) the scrape endpoint over this runtime's
        registry: Prometheus text at ``/metrics``, JSON at
        ``/metrics.json`` (including ``stats()``), recent spans at
        ``/traces``.  Owned by the runtime — ``close()`` stops it.
        Returns the ``repro_torch.obs.expo.MetricsServer`` (``.url``)."""
        if self._obs is None:
            raise RuntimeError("observability is disabled (obs=False); "
                               "no metrics to serve")
        if self._metrics_server is None:
            from ..obs.expo import MetricsServer
            self._metrics_server = MetricsServer(
                self._obs.registry, traces=self._obs.traces,
                extra=self.stats, host=host, port=port).start()
            _LOG.info("metrics_endpoint", url=self._metrics_server.url)
        return self._metrics_server
