"""repro_torch.obs — metrics and structured logging; the port's counterpart
of ``repro.obs``, with the two modules the autotuner imports:

  * ``obs.metrics`` — thread-safe registry: counters, gauges, bounded
    histograms, labels, a process-wide default instance (``REPRO_OBS=0``
    starts it disabled), Prometheus text and a JSON snapshot;
  * ``obs.log``     — structured ``key=value`` logger (``REPRO_LOG_LEVEL``;
    quiet by default under pytest).

Waiting for the serving-runtime slice (ROADMAP Queue A item 9): ``expo``
(the HTTP exposition server), ``trace`` (request spans), ``retrace``
(compile watchers) and ``serving`` (the serving metric catalog).

Nothing here imports the rest of ``repro_torch`` at module scope, so any
module can import ``repro_torch.obs`` without a cycle.
"""
from .log import StructLogger, get_logger, set_level
from .metrics import (Counter, Gauge, Histogram, MetricFamily,
                      MetricsRegistry, get_registry, set_default_registry)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricFamily", "MetricsRegistry",
    "get_registry", "set_default_registry",
    "StructLogger", "get_logger", "set_level",
]
