"""BENCHMARK.json against the benchmark's contract: names, units, files
and readers, and what every cell reports."""
import json
import re

import pytest

from chipbench import harness
from chipbench.tests.tiny import ROOT

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert "chipbench" in MANIFEST["paths"] and len(MANIFEST["paths"]) <= 16
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"], ids=lambda e: e["name"])
def test_config(entry):
    assert NAME.match(entry["name"]) and len(entry["reduced"]) <= 16
    assert all(NAME.match(key) for key in entry["reduced"])
    assert entry["file"].startswith("chipbench/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert (ROOT / "chipbench" / "models" / f"{cfg['model']}.py").exists()
    assert (ROOT / "chipbench" / "datasets" / f"{cfg['dataset']}.py").exists()
    assert set(cfg["limits"]) >= {"score_gap"}


@pytest.mark.parametrize("cell", MANIFEST["workloads"], ids=lambda e: e["name"])
def test_cell(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert (ROOT / "chipbench" / "traffic" / f"{cell['traffic']}.json").exists()
    e2e = {m["name"] for m in harness.cell_metrics(MANIFEST, cell["name"],
                                                  False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(MANIFEST, cell["name"], True)


@pytest.mark.parametrize("metric", MANIFEST["end_to_end"] +
                         MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_metric(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(harness.reader(metric["name"]).read)
    cells = {c["name"] for c in MANIFEST["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["layer"] and "\n" not in metric["layer"]
        for cell in metric.get("workloads", []):   # reports what it moves
            assert metric["moves"] in {
                m["name"] for m in harness.cell_metrics(MANIFEST, cell,
                                                        False)}
