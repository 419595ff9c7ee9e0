"""Thread-safe metrics registry: counters, gauges, bounded histograms; the
port's copy of ``repro.obs.metrics`` (same metric model, Prometheus text and
JSON snapshot).

The paper's conclusion — the best implementation depends on the forest
AND the device — means a production deployment is constantly making
runtime decisions: which engine the autotuner picked, how the SLO
controller moved the batching knobs, which cascade stage a request
exited at, whether a live request just paid an XLA retrace.  This
module is the process-wide ledger those decisions are written to, and
``repro.obs.expo`` is how an operator reads it (Prometheus text or a
JSON snapshot — docs/OBSERVABILITY.md has the metric catalog).

Model (a deliberately small subset of the Prometheus data model):

  * ``Counter``   — monotonically increasing float (``inc``).
  * ``Gauge``     — set/inc/dec to any value (queue depth, knobs).
  * ``Histogram`` — bounded value stream: exact count/sum plus
    percentiles from a capped sample (``inference.server.Reservoir`` —
    Algorithm R, so a month of traffic holds O(cap) floats).
  * Every metric is a *family* keyed by name; label names are declared
    at creation and each distinct label-value tuple materializes one
    child series (``family.labels(tenant="alpha").inc()``).

Concurrency: one registry-wide lock guards family creation, child
creation, every mutation, and every scrape — scrapes therefore see a
consistent point-in-time view, and the thread-hammer test in
``tests/test_torch_obs.py`` pins that concurrent updates + scrapes never
corrupt a counter.  The ops inside the lock are a float add or a
reservoir append, so the critical section is nanoseconds.

Cost when disabled: every mutating op checks ``registry.enabled``
before taking the lock — one attribute load and a branch.  The
process-wide default registry honors ``REPRO_OBS=0`` at import.
"""
from __future__ import annotations

import json
import re
import threading
from typing import Optional

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: percentiles a histogram exposes (Prometheus summary quantiles)
QUANTILES = (0.5, 0.9, 0.99)


def _reservoir(cap: int):
    # deferred so `import repro_torch.obs` never pulls the serving stack
    # (and with it torch) — obs must stay import-cycle-free: the server
    # may import obs, obs only ever imports inference lazily
    from ..inference.server import Reservoir
    return Reservoir(cap=cap)


def escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Child:
    """One concrete time series: a family narrowed to one label tuple."""

    __slots__ = ("_family",)

    def __init__(self, family: "MetricFamily"):
        self._family = family

    @property
    def _lock(self):
        return self._family._reg._lock

    @property
    def _enabled(self) -> bool:
        return self._family._reg.enabled


class Counter(_Child):
    __slots__ = ("_value",)
    kind = "counter"

    def __init__(self, family):
        super().__init__(family)
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if not self._enabled:
            return
        if v < 0:
            raise ValueError(f"counter increments must be >= 0, got {v}")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    __slots__ = ("_value",)
    kind = "gauge"

    def __init__(self, family):
        super().__init__(family)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value = float(v)

    def inc(self, v: float = 1.0) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    __slots__ = ("_res",)
    kind = "histogram"

    def __init__(self, family):
        super().__init__(family)
        self._res = _reservoir(family.cap)

    def observe(self, v: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            self._res.append(float(v))

    @property
    def count(self) -> int:
        with self._lock:
            return self._res.n

    @property
    def sum(self) -> float:
        with self._lock:
            return self._res.total

    def percentile(self, q: float) -> Optional[float]:
        with self._lock:
            return self._res.percentile(q) if self._res else None


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """All series sharing one metric name (and one label-name schema)."""

    def __init__(self, reg: "MetricsRegistry", name: str, help: str,
                 kind: str, label_names: tuple, cap: int = 2048):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} "
                             f"(must match {_NAME_RE.pattern})")
        for ln in label_names:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self._reg = reg
        self.name = name
        self.help = help
        self.kind = kind
        self.label_names = tuple(label_names)
        self.cap = cap
        self._children: dict[tuple, _Child] = {}

    def labels(self, **kv) -> _Child:
        """The child series for this exact label assignment (created on
        first use).  Label *names* must match the declared schema."""
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.label_names}, "
                f"got {tuple(sorted(kv))}")
        key = tuple(str(kv[ln]) for ln in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._reg._lock:
                child = self._children.get(key)
                if child is None:
                    child = _KINDS[self.kind](self)
                    self._children[key] = child
        return child

    # ------------------------------------------------- label-free sugar
    def _solo(self) -> _Child:
        if self.label_names:
            raise ValueError(
                f"metric {self.name!r} is labeled {self.label_names}; "
                "narrow it with .labels(...) first")
        return self.labels()

    def inc(self, v: float = 1.0) -> None:
        self._solo().inc(v)

    def set(self, v: float) -> None:
        self._solo().set(v)

    def dec(self, v: float = 1.0) -> None:
        self._solo().dec(v)

    def observe(self, v: float) -> None:
        self._solo().observe(v)

    @property
    def value(self) -> float:
        return self._solo().value

    @property
    def count(self) -> int:
        return self._solo().count

    @property
    def sum(self) -> float:
        return self._solo().sum

    def percentile(self, q: float) -> Optional[float]:
        return self._solo().percentile(q)

    # ---------------------------------------------------------- readout
    def samples(self) -> list:
        """JSON-clean sample dicts for every child (call under the
        registry lock for a consistent scrape)."""
        out = []
        for key, child in self._children.items():
            labels = dict(zip(self.label_names, key))
            if self.kind == "histogram":
                res = child._res
                rec = {"labels": labels, "count": res.n, "sum": res.total}
                for q in QUANTILES:
                    rec[f"p{int(q * 100)}"] = (
                        res.percentile(q * 100) if res else None)
                out.append(rec)
            else:
                out.append({"labels": labels, "value": child._value})
        return out


class MetricsRegistry:
    """Get-or-create metric families + consistent scrapes.

    Re-requesting an existing name returns the same family object —
    with a loud ``ValueError`` if the kind or label schema disagrees
    (two subsystems silently sharing a name with different meanings is
    exactly the bug a registry exists to prevent)."""

    def __init__(self, enabled: bool = True):
        self._lock = threading.RLock()
        self._families: dict[str, MetricFamily] = {}
        self.enabled = bool(enabled)

    def enable(self, on: bool = True) -> None:
        self.enabled = bool(on)

    # ------------------------------------------------------ constructors
    def _family(self, name: str, help: str, kind: str, labels: tuple,
                **kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.label_names != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, requested "
                        f"{kind}{tuple(labels)}")
                return fam
            fam = MetricFamily(self, name, help, kind, tuple(labels), **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: tuple = ()) -> MetricFamily:
        return self._family(name, help, "counter", labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple = ()) -> MetricFamily:
        return self._family(name, help, "gauge", labels)

    def histogram(self, name: str, help: str = "", labels: tuple = (),
                  cap: int = 2048) -> MetricFamily:
        return self._family(name, help, "histogram", labels, cap=cap)

    def names(self) -> tuple:
        with self._lock:
            return tuple(self._families)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    # ---------------------------------------------------------- readout
    def snapshot(self) -> dict:
        """JSON-clean point-in-time view of every family: ``{name:
        {type, help, labelnames, samples}}`` — round-trips through
        ``json.dumps``/``loads`` unchanged (pinned by tests)."""
        with self._lock:
            return {
                name: {
                    "type": fam.kind,
                    "help": fam.help,
                    "labelnames": list(fam.label_names),
                    "samples": fam.samples(),
                }
                for name, fam in self._families.items()
            }

    def prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4).  Histograms are
        exported as summaries: ``name{quantile="0.5"}``, ``name_sum``,
        ``name_count``."""
        lines: list[str] = []
        with self._lock:
            for name, fam in self._families.items():
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                kind = "summary" if fam.kind == "histogram" else fam.kind
                lines.append(f"# TYPE {name} {kind}")
                for key, child in fam._children.items():
                    pairs = [f'{ln}="{escape_label_value(v)}"'
                             for ln, v in zip(fam.label_names, key)]

                    def series(extra: str = "", base: str = name) -> str:
                        lab = pairs + ([extra] if extra else [])
                        return base + ("{" + ",".join(lab) + "}"
                                       if lab else "")

                    if fam.kind == "histogram":
                        res = child._res
                        if res:
                            for q in QUANTILES:
                                qlab = 'quantile="%g"' % q
                                lines.append(
                                    f"{series(qlab)} "
                                    f"{res.percentile(q * 100):.17g}")
                        lines.append(f"{series(base=name + '_sum')} "
                                     f"{res.total:.17g}")
                        lines.append(f"{series(base=name + '_count')} "
                                     f"{res.n}")
                    else:
                        lines.append(f"{series()} {child._value:.17g}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), indent=1)


# --------------------------------------------------------------------------- #
# Process-wide default registry
# --------------------------------------------------------------------------- #
def _env_enabled() -> bool:
    import os
    return os.environ.get("REPRO_OBS", "1").lower() not in (
        "0", "off", "false", "no")


_DEFAULT = MetricsRegistry(enabled=_env_enabled())


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (``REPRO_OBS=0`` starts it
    disabled).  Subsystems that are not handed an explicit registry —
    the autotuner — write here."""
    return _DEFAULT


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide default (tests isolate themselves with a
    fresh registry); returns the previous one so callers can restore."""
    global _DEFAULT
    old, _DEFAULT = _DEFAULT, reg
    return old
