"""The serving metric catalog + per-process instrumentation bundle; the
port's copy of ``repro.obs.serving`` (the same 13 names, kinds and label
schemas).

``METRIC_CATALOG`` is the contract a live scrape is checked against
(``scripts/torch_check_engines.py --obs``, ``chip_smoke.py``).
``ServingMetrics`` materializes it on a registry and is shared by
``ServingRuntime`` (full instrumentation: phases, spans, first-use
detection) and ``ForestServer`` (the synchronous path:
latency/phase/throughput).

Labels: ``tenant`` is the model id (``ForestServer`` uses its
``obs_label``); ``phase`` is one of ``repro_torch.obs.trace.PHASES``;
``stage`` is the cascade stage index; ``action`` is the controller
decision (grow/shrink/hold).
"""
from __future__ import annotations

from .metrics import MetricsRegistry
from .trace import TraceBuffer

#: name -> (kind, label names, help).  Every entry is created up front
#: so a scrape always exposes the full catalog (HELP/TYPE lines appear
#: even before the first sample).
METRIC_CATALOG = {
    "repro_requests_total": (
        "counter", ("tenant",),
        "Requests completed (resolved futures), per tenant"),
    "repro_request_errors_total": (
        "counter", ("tenant",),
        "Requests resolved with an exception, per tenant"),
    "repro_batches_total": (
        "counter", ("tenant",),
        "Batches dispatched, per tenant"),
    "repro_batch_size": (
        "histogram", ("tenant",),
        "Requests per dispatched batch"),
    "repro_latency_ms": (
        "histogram", ("tenant",),
        "End-to-end request latency (submit to scores on host), ms"),
    "repro_phase_ms": (
        "histogram", ("tenant", "phase"),
        "Per-phase request latency breakdown "
        "(queue/form/pad/compute/sync), ms"),
    "repro_queue_depth": (
        "gauge", ("tenant",),
        "Requests waiting in the tenant's micro-batcher queue"),
    "repro_effective_max_batch": (
        "gauge", ("tenant",),
        "Effective max_batch after SLO controller decisions"),
    "repro_effective_max_wait_ms": (
        "gauge", ("tenant",),
        "Effective max_wait_ms after SLO controller decisions"),
    "repro_controller_decisions_total": (
        "counter", ("tenant", "action"),
        "SLO controller window decisions (grow/shrink/hold)"),
    "repro_cascade_stage_exits_total": (
        "counter", ("tenant", "stage"),
        "Cascade rows exiting at each stage, per tenant"),
    "repro_compile_events_total": (
        "counter", ("tenant",),
        "First uses observed: input shapes a predictor's compute had not "
        "run before (allocator growth, lazy kernel load, per-shape "
        "layouts), per tenant"),
    "repro_retrace_anomalies_total": (
        "counter", ("tenant",),
        "First uses after warmup — a shape leaked past the bucket "
        "ladder (should stay 0)"),
}


class ServingMetrics:
    """The catalog, materialized on one registry, plus the trace ring.

    Attribute names are the catalog names minus the ``repro_`` prefix
    (``self.requests_total``, ``self.latency_ms``, ...)."""

    def __init__(self, registry: MetricsRegistry, trace_cap: int = 256):
        self.registry = registry
        self.traces = TraceBuffer(cap=trace_cap)
        for name, (kind, labels, help_) in METRIC_CATALOG.items():
            fam = getattr(registry, kind)(name, help_, labels=labels)
            setattr(self, name.removeprefix("repro_"), fam)

    @property
    def enabled(self) -> bool:
        return self.registry.enabled
