"""Request tracing: where did this request's 12 ms go?  The port's copy of
``repro.obs.trace`` (same fields, phase order and JSON shape).

A ``Span`` is one served request's phase breakdown, stamped by the
serving layer as the batch it rode in moves through dispatch
(``inference.runtime.ServingRuntime._run_batch``):

  * ``queue_ms``   — submit → the dispatch rule fired (arrival-relative,
    measured on the runtime's clock, so virtual-clock tests stamp
    deterministic values);
  * ``form_ms``    — stacking the drained requests into one (B, d) batch;
  * ``pad_ms``     — zero-padding to the power-of-two bucket (plain
    engines only; cascade and kernel tenants bucket internally);
  * ``compute_ms`` — the predictor call until it returns.  Every port
    predictor returns host numpy, so this already holds the wait for the
    card;
  * ``sync_ms``    — ``torch.cuda.synchronize`` when a predictor hands
    back a tensor on the card; ≈ 0 for the port's predictors.

Sub-phase durations come from ``time.perf_counter`` deltas (monotonic —
the same contract as the serving stats); only ``queue_ms`` uses the
injectable runtime clock, which keeps spans meaningful under both the
threaded loop and the virtual-clock ``pump``/``flush`` twin.

``TraceBuffer`` is a bounded, thread-safe ring of recent spans — the
flight recorder an operator pulls as JSON from the metrics endpoint
(``GET /traces``) after a latency spike, without grepping logs or
re-running traffic.
"""
from __future__ import annotations

import json
import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

#: canonical phase order
PHASES = ("queue_ms", "form_ms", "pad_ms", "compute_ms", "sync_ms")


@dataclass
class Span:
    """One request's trace through the serving runtime."""
    rid: int
    tenant: str
    arrival_s: float
    batch_size: int = 0               # requests in the batch it rode in
    bucket: int = 0                   # padded batch the engine saw
    phases: dict = field(default_factory=dict)      # phase -> ms
    total_ms: Optional[float] = None  # submit -> scores on the host
    exit_stage: Optional[int] = None  # cascade: reserved (batch-level
    #                                   exit counts live in the metrics)
    ok: bool = True
    error: Optional[str] = None

    def to_dict(self) -> dict:
        """JSON-clean dict (what /traces serves)."""
        out = {
            "rid": self.rid,
            "tenant": self.tenant,
            "arrival_s": float(self.arrival_s),
            "batch_size": int(self.batch_size),
            "bucket": int(self.bucket),
            "phases": {k: float(v) for k, v in self.phases.items()},
            "total_ms": (float(self.total_ms)
                         if self.total_ms is not None else None),
            "ok": bool(self.ok),
        }
        if self.error is not None:
            out["error"] = self.error
        if self.exit_stage is not None:
            out["exit_stage"] = int(self.exit_stage)
        return out


class TraceBuffer:
    """Bounded ring of recent spans (newest last), thread-safe."""

    def __init__(self, cap: int = 256):
        if cap < 1:
            raise ValueError(f"trace buffer cap must be >= 1, got {cap}")
        self.cap = cap
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=cap)
        self.n_added = 0              # spans ever recorded (exact)

    def add(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)
            self.n_added += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def recent(self, n: Optional[int] = None) -> list:
        """The most recent ``n`` spans (all retained by default) as
        JSON-clean dicts, oldest first."""
        with self._lock:
            spans = list(self._ring)
        if n is not None:
            spans = spans[-int(n):]
        return [s.to_dict() for s in spans]

    def to_json(self, n: Optional[int] = None) -> str:
        return json.dumps(self.recent(n), indent=1)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
