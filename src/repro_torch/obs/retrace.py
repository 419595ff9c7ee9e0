"""First-use detection: the port's counterpart of ``repro.obs.retrace``.

The reference watches jit trace caches: a post-warmup trace means a
shape leaked past the bucket ladder and a request just paid a compile.
The port has no jit.  Its counterpart of a trace-cache entry is **an
input shape a predictor's compute has not run before**: on the card that
is where a live request pays first-use costs — the caching allocator
grows for a new padded batch, the kernel's module loads lazily, the
fused cascade's generic tier meets a new bucket, and the kernels'
per-forest layouts are computed (the ``lru_cache``\\ s of
``kernels/launch.py`` and ``kernels/cascade_kernel.py``).  So every port
predictor keeps the set of shapes its compute ran and reports its size:

  * ``core.registry.BasePredictor.trace_cache_size()`` — the distinct
    input shapes that reached its evaluator;
  * ``kernels.ops._KernelPredictor`` — the distinct padded shapes it
    launched its kernel on;
  * ``cascade.CascadePredictor`` — the sum over its stages;
  * ``cascade.FusedCascadePredictor`` — the stages' sum plus the
    distinct buckets its program ran; ``set_policy`` drops the program
    and its buckets, so the count shrinks.

This module reads those counts:

  * ``fn_cache_size(fn)`` — entries of one callable's cache: its
    ``_cache_size()`` where it has one, else ``cache_info().currsize``
    of a ``functools.lru_cache`` (``None`` when it has neither);
  * ``jit_cache_size(pred)`` — a ``trace_cache_size()`` method wins;
    otherwise the surfaces ``_fn`` and ``_jit_cache`` are scanned;
  * ``CompileWatch`` — per-tenant delta tracker.  ``poll()`` after each
    batch returns ``(compiles, anomalies)``: every growth is a compile
    event (a first use); growths after ``mark_warm()`` are anomalies.  A
    *shrink* (``set_policy`` dropping the fused program) resets the
    baseline instead of counting negative.

``ServingRuntime`` polls after every batch and feeds the
``repro_compile_events_total`` / ``repro_retrace_anomalies_total``
counters.
"""
from __future__ import annotations

from typing import Optional


def fn_cache_size(fn) -> Optional[int]:
    """Cache entries of one callable, or ``None`` if it has no cache to
    inspect (plain Python callables)."""
    cs = getattr(fn, "_cache_size", None)
    if callable(cs):
        try:
            return int(cs())
        except Exception:           # noqa: BLE001 — a foreign API: degrade
            return None             # to "unobservable", never raise
    info = getattr(fn, "cache_info", None)
    if callable(info):
        try:
            return int(info().currsize)
        except Exception:           # noqa: BLE001 — as above
            return None
    return None


def jit_cache_size(pred) -> Optional[int]:
    """Total first-use entries reachable from a predictor, or ``None``
    when nothing observable was found (monitoring then degrades to no-op
    rather than miscounting)."""
    meth = getattr(pred, "trace_cache_size", None)
    if callable(meth):
        return meth()
    total, found = 0, False
    size = fn_cache_size(getattr(pred, "_fn", None))
    if size is not None:
        total, found = total + size, True
    cache = getattr(pred, "_jit_cache", None)
    if isinstance(cache, dict):
        for fn in cache.values():
            size = fn_cache_size(fn)
            if size is not None:
                total, found = total + size, True
    return total if found else None


class CompileWatch:
    """Delta tracker over one predictor's first-use counts.

    ``poll()`` is cheap (a few attribute reads per call) and safe on
    predictors with no observable count — it just reports zeros."""

    def __init__(self, pred):
        self.pred = pred
        self.warmed = False
        self.compiles_total = 0       # every observed growth
        self.anomalies_total = 0      # growths after mark_warm()
        self._last = jit_cache_size(pred) or 0

    @property
    def observable(self) -> bool:
        return jit_cache_size(self.pred) is not None

    def refresh(self) -> None:
        """Re-baseline without counting (e.g. right after warmup ran the
        bucket ladder on purpose)."""
        self._last = jit_cache_size(self.pred) or 0

    def mark_warm(self) -> None:
        """From here on, any new shape is an anomaly."""
        self.refresh()
        self.warmed = True

    def poll(self) -> tuple:
        """(new compile events, new anomalies) since the last poll."""
        size = jit_cache_size(self.pred)
        if size is None:
            return 0, 0
        delta = size - self._last
        self._last = size
        if delta <= 0:
            # shrink = a deliberate reset (policy swap); re-baseline
            return 0, 0
        self.compiles_total += delta
        if self.warmed:
            self.anomalies_total += delta
            return delta, delta
        return delta, 0
