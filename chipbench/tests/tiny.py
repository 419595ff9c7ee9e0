"""A tiny copy of the benchmark's cells for runs on the CPU: the same
model makers, datasets and metrics, at sizes a test can hold.

Each configuration and traffic mix file may carry a ``tiny`` block: the
keys it changes for the CPU copy (a nested group is merged one level
deep).  A file without one is copied as it is."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def cut(doc: dict) -> dict:
    """``doc`` with its ``tiny`` block laid over it."""
    out = {k: v for k, v in doc.items() if k != "tiny"}
    for key, value in doc.get("tiny", {}).items():
        out[key] = {**out[key], **value} if isinstance(value, dict) \
            else value
    return out


def tiny_root(tmp: Path) -> tuple[Path, dict]:
    """A checkout-like folder under ``tmp`` holding the manifest's configs
    and mixes cut to their tiny sizes; returns (root, manifest)."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = [e["file"] for e in manifest["configs"]] + sorted(
        {f"chipbench/traffic/{w['traffic']}.json"
         for w in manifest["workloads"]})
    for rel in files:
        path = tmp / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cut(json.loads((ROOT / rel).read_text()))))
    return tmp, manifest
