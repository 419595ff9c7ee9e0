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

**In-program spans** (``begin``/``end``, ``span``, ``enable``, ``drain``)
time the port's own code beneath one ``predict`` call and a forest
build, on any caller's path; they share no state with ``Span``:

  * ``repro_torch.predict``  — the root, one per call (``rows``);
  * ``repro_torch.transform`` — ``transform_inputs`` (input quantization);
  * ``repro_torch.pad``      — dtype, width check and padding to the row
    bucket (``rows``, ``padded_rows``);
  * ``repro_torch.h2d``      — the copy of the padded rows to the device
    (``nbytes``);
  * ``repro_torch.launch``   — the host's enqueue of the kernel and of
    the device ops around it;
  * ``repro_torch.d2h``      — one blocking device→host read: the wait
    for the device plus the copy (``nbytes``); a call's host syncs are
    its count of these;
  * ``repro_torch.descale``  — the host's cast and descale of the result;
  * ``repro_torch.compile_arrays`` — a host build of a kernel's arrays.

They are off by default.  Off, ``begin`` and ``end`` return after one
check of a module flag: no allocation, no clock, no profiler.  On, a
span stamps start and end with ``time.time_ns()``, the Unix-epoch
clock that ``torch.profiler``'s events carry, keeps its record in a
bounded buffer that counts what it drops, and, while a profiler runs,
also opens ``torch.profiler.record_function(name)``, so the profiler's
trace carries the program's spans on the same clock.  Spans nest per
thread; every span of one call carries the root's id as ``call``.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
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


# --------------------------------------------------------------------------- #
# In-program spans
# --------------------------------------------------------------------------- #
_ON = False                 # the one check a span makes while off
_CAPACITY = 1 << 18         # records the buffer holds between drains
_records: list = []         # (name, start_ns, end_ns, id, parent, call,
#                             rows, padded_rows, nbytes)
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: this thread's open spans
_torch = None               # torch, imported by the first ``enable``
_profiling = None           # torch's "is a profiler running" check


def enable(on: bool = True) -> None:
    """Switch the in-program spans on or off, process-wide."""
    global _ON, _torch, _profiling
    if on and _torch is None:
        import torch
        _torch, _profiling = torch, torch.autograd._profiler_enabled
    _ON = bool(on)


def enabled() -> bool:
    return _ON


def begin(name: str):
    """Open a span on this thread; returns the token for ``end`` (None
    while spans are off).  The per-call hot path uses ``begin``/``end``
    because a ``with`` costs more than the flag check even when off."""
    if not _ON:
        return None
    try:
        stack = _local.stack
    except AttributeError:
        stack = _local.stack = []
    sid = next(_ids)
    parent, call = (stack[-1][1], stack[-1][3]) if stack else (None, sid)
    t0 = time.time_ns()
    rf = None
    if _profiling():
        rf = _torch.profiler.record_function(name)
        rf.__enter__()
    token = (name, sid, parent, call, t0, rf)
    stack.append(token)
    return token


def end(token, rows: Optional[int] = None, padded_rows: Optional[int] = None,
        nbytes: Optional[int] = None) -> None:
    """Close the span ``token`` (a no-op for None) with its counts.
    Spans it left open, whose ``end`` an exception skipped, close with it
    and are not recorded."""
    global _dropped
    if token is None:
        return
    stack = getattr(_local, "stack", [])
    if not stack or stack[-1] is not token:
        if token not in stack:
            return                              # closed already
        while stack[-1] is not token:
            rf = stack.pop()[5]
            if rf is not None:
                rf.__exit__(None, None, None)
    stack.pop()
    name, sid, parent, call, t0, rf = token
    if rf is not None:
        rf.__exit__(None, None, None)           # the profiler's span
    rec = (name, t0, time.time_ns(), sid, parent, call, rows, padded_rows,
           nbytes)
    _lock.acquire()
    if len(_records) < _CAPACITY:
        _records.append(rec)
    else:
        _dropped += 1
    _lock.release()


@contextlib.contextmanager
def span(name: str, rows: Optional[int] = None,
         padded_rows: Optional[int] = None, nbytes: Optional[int] = None):
    """``begin``/``end`` as a context manager, for paths outside the
    per-call hot path (a forest build)."""
    token = begin(name)
    try:
        yield
    finally:
        end(token, rows=rows, padded_rows=padded_rows, nbytes=nbytes)


_FIELDS = ("name", "start_ns", "end_ns", "id", "parent", "call")
_COUNTS = ("rows", "padded_rows", "nbytes")


def drain() -> list:
    """The recorded spans as dicts, in the order they closed, and an
    empty buffer: ``name``, ``start_ns``, ``end_ns``, ``id``, ``parent``
    (None for a root), ``call`` (the root's id) and the counts given."""
    with _lock:
        recs = _records[:]
        _records.clear()
    out = []
    for rec in recs:
        d = dict(zip(_FIELDS, rec))
        d.update((k, v) for k, v in zip(_COUNTS, rec[6:]) if v is not None)
        out.append(d)
    return out


def dropped() -> int:
    """Spans discarded because the buffer was full, since the process
    started."""
    return _dropped
