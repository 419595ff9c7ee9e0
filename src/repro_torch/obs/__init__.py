"""repro_torch.obs — end-to-end observability; the port's counterpart of
``repro.obs``:

  * ``obs.metrics``  — thread-safe registry: counters, gauges, bounded
    histograms, labels, a process-wide default instance (``REPRO_OBS=0``
    starts it disabled), Prometheus text and a JSON snapshot;
  * ``obs.trace``    — per-request spans (queue/form/pad/compute/sync
    phases) in a bounded ring buffer, retrievable as JSON, and the
    program's own spans beneath one ``predict`` call and a forest build
    (``begin``/``end``, ``enable``, ``drain``; off by default);
  * ``obs.retrace``  — first-use watchers: a shape a predictor's compute
    had not run before counts as a compile event, and one after warmup
    surfaces as an anomaly instead of a silent latency spike;
  * ``obs.log``      — structured ``key=value`` logger (``REPRO_LOG_LEVEL``;
    quiet by default under pytest);
  * ``obs.expo``     — Prometheus text + JSON snapshot served from a
    stdlib HTTP thread on loopback (``ServingRuntime.serve_metrics``);
  * ``obs.serving``  — the serving metric catalog (the contract a live
    scrape is checked against).

Nothing here imports the rest of ``repro_torch`` at module scope, so any
module can import ``repro_torch.obs`` without a cycle.
"""
from .expo import MetricsServer, json_snapshot
from .log import StructLogger, get_logger, set_level
from .metrics import (Counter, Gauge, Histogram, MetricFamily,
                      MetricsRegistry, get_registry, set_default_registry)
from .retrace import CompileWatch, fn_cache_size, jit_cache_size
from .serving import METRIC_CATALOG, ServingMetrics
from .trace import PHASES, Span, TraceBuffer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "get_registry", "set_default_registry",
    "Span", "TraceBuffer", "PHASES",
    "CompileWatch", "fn_cache_size", "jit_cache_size",
    "StructLogger", "get_logger", "set_level",
    "MetricsServer", "json_snapshot",
    "METRIC_CATALOG", "ServingMetrics",
]
