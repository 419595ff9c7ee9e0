"""Structured logging: level + component + key=value fields; the port's
copy of ``repro.obs.log`` (same environment variable, same line format).

One small, dependency-free logger whose output is grep- and
machine-friendly:

    2026-08-07T12:00:01.123 INFO  serve  fleet_saved manifest=/tmp/m.json

Semantics:

  * Levels ``debug < info < warning < error``; the effective level is
    resolved **per call** from ``REPRO_LOG_LEVEL`` when set, else
    ``warning`` under pytest (quiet-by-default in tests — the suite's
    output stays readable), else ``info``.
  * One line per event, written to ``stderr`` and flushed — stdout
    stays reserved for the scripts' JSON results.
  * Values render as ``key=value``; values containing whitespace or
    ``=`` are quoted via ``repr`` so a line always splits back into
    fields.

This is deliberately not the stdlib ``logging`` module: no handler
graphs, no global config mutation from a library, no formatter state —
the callers are scripts, and a scripted deployment greps these
lines or ships them as-is.
"""
from __future__ import annotations

import datetime
import os
import sys
import threading
from typing import Optional, TextIO

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}

_lock = threading.Lock()
_loggers: dict[str, "StructLogger"] = {}
_forced_level: Optional[str] = None


def set_level(level: Optional[str]) -> None:
    """Force the process-wide level (``None`` restores env resolution)."""
    global _forced_level
    if level is not None and level not in LEVELS:
        raise ValueError(f"unknown log level {level!r}; "
                         f"one of {sorted(LEVELS)}")
    _forced_level = level


def effective_level() -> str:
    """Resolved per call so env/monkeypatch changes take effect live."""
    if _forced_level is not None:
        return _forced_level
    env = os.environ.get("REPRO_LOG_LEVEL", "").lower()
    if env in LEVELS:
        return env
    if "PYTEST_CURRENT_TEST" in os.environ or "pytest" in sys.modules:
        return "warning"              # quiet-by-default under pytest
    return "info"


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    if s == "" or any(c in s for c in (" ", "=", '"', "\n", "\t")):
        return repr(s)
    return s


class StructLogger:
    """One component's logger; see the module docstring for the line
    format.  ``stream=`` injects the sink (tests capture a StringIO)."""

    def __init__(self, component: str, stream: Optional[TextIO] = None):
        self.component = component
        self._stream = stream

    def enabled_for(self, level: str) -> bool:
        return LEVELS[level] >= LEVELS[effective_level()]

    def log(self, level: str, event: str, **fields) -> None:
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}")
        if not self.enabled_for(level):
            return
        ts = datetime.datetime.now().isoformat(timespec="milliseconds")
        parts = [ts, level.upper().ljust(5), self.component, event]
        parts += [f"{k}={_fmt_value(v)}" for k, v in fields.items()]
        stream = self._stream if self._stream is not None else sys.stderr
        with _lock:                   # interleaved lines stay whole
            print(" ".join(parts), file=stream, flush=True)

    def debug(self, event: str, **fields) -> None:
        self.log("debug", event, **fields)

    def info(self, event: str, **fields) -> None:
        self.log("info", event, **fields)

    def warning(self, event: str, **fields) -> None:
        self.log("warning", event, **fields)

    def error(self, event: str, **fields) -> None:
        self.log("error", event, **fields)


def get_logger(component: str) -> StructLogger:
    """Process-wide logger per component name (cached)."""
    with _lock:
        lg = _loggers.get(component)
        if lg is None:
            lg = _loggers[component] = StructLogger(component)
        return lg
