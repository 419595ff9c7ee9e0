"""Autotuner cache → cost-model training rows (docs/AUTOTUNE.md).

Every schema-v2 cache entry already carries everything a training row
needs: ``meta`` (the ``engine_select.shape_meta`` feature view — forest
shape, batch bucket, backend, device fingerprint) and per-candidate
``bench_us`` labels (steady-state microseconds per instance) with
``compile_s`` alongside.  This module flattens that into rows and parses
candidate names back into their per-axis tags — the inverse of
``engine_select._candidate_factories``'s ``cname``.

v1 entries (pre-fingerprint, no ``meta``/``bench_us``) are skipped: they
predate the feature/label contract and their keys can no longer be hit
anyway.
"""
from __future__ import annotations

import os
import re

AXES = ("engine", "quant", "opt", "layout", "cascade", "flint")

_QUANT = re.compile(r"q\d+")


def parse_candidate(name: str) -> dict:
    """Candidate name → per-axis tags.

    Names are ``engine[@qTAG][@flint][@OPT][@kw=v,...][@cascade...=...]``
    (see ``_candidate_factories``).  The segments are self-describing, so
    parsing is order-insensitive: ``flint`` literal, ``cascade...``
    prefix, ``q<bits>...`` quant tags, anything with ``=`` is a layout
    kw set, and the remainder (``O2``, ``dedup_thresholds+compact``) is
    the optimizer tag.  Absent axes parse to ``""`` (``False`` for
    flint) — the cost model one-hots these as their own category."""
    parts = name.split("@")
    axes = {"engine": parts[0], "quant": "", "opt": "", "layout": "",
            "cascade": "", "flint": False}
    for p in parts[1:]:
        if p == "flint":
            axes["flint"] = True
        elif p.startswith("cascade"):
            axes["cascade"] = p
        elif _QUANT.match(p) and not axes["quant"]:
            axes["quant"] = p
        elif "=" in p:
            axes["layout"] = p
        else:
            axes["opt"] = p
    return axes


def rows_from_entries(entries: dict) -> list:
    """Flatten cache entries (``key → entry``, the on-disk layout) into
    training rows: ``{"key", "candidate", "axes", "meta", "us",
    "compile_s"}`` — one row per (shape key, candidate) measurement."""
    rows = []
    for key, entry in entries.items():
        if not isinstance(entry, dict):
            continue
        meta = entry.get("meta")
        bench_us = entry.get("bench_us")
        if not isinstance(meta, dict) or not isinstance(bench_us, dict) \
                or not bench_us:
            continue                  # v1 entry: no feature/label contract
        compile_s = entry.get("compile_s") or {}
        for cand, us in bench_us.items():
            if not isinstance(us, (int, float)) or isinstance(us, bool) \
                    or us <= 0:
                continue
            rows.append({
                "key": key, "candidate": cand,
                "axes": parse_candidate(cand), "meta": meta,
                "us": float(us),
                "compile_s": float(compile_s.get(cand) or 0.0),
            })
    return rows


def extract_rows(paths=None) -> list:
    """Training rows from one or more autotuner cache files.  ``paths``
    may be a single path, a sequence, or ``None`` for the process default
    (``engine_select.default_cache_path()``).  Unreadable or malformed
    files contribute nothing — same degrade-to-resweep posture as the
    cache itself."""
    from ..core import engine_select
    if paths is None:
        paths = [engine_select.default_cache_path()]
    elif isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    rows = []
    for p in paths:
        rows.extend(rows_from_entries(engine_select._load_disk(os.fspath(p))))
    return rows
