"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped), the control and planted faults, which must read as not correct,
and the guards of the command line."""
import copy
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from chipbench import harness
from chipbench.tests.tiny import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]
# the cells whose timed path the planted faults below know how to break
FAULT_CELLS = ["msn1_qs_20000x64.bulk", "magic_rf_512x64_cascade.bulk",
               "msn1_qs_20000x64.query"]
SEED = 2 ** 31 + 17


def _run(tiny, workload, traced=False, program_cfg=None):
    root, manifest = tiny
    cell = harness.Cell(manifest, root, workload, "cpu", program_cfg)
    w = cell.measure(SEED, 0.2, traced, 0.0)
    cell.close()
    return cell.judge(w, traced)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cell_runs_correct(tiny, workload, traced):
    r = _run(tiny, workload, traced)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    metrics = harness.cell_metrics(tiny[1], workload, traced)
    # on the CPU the device's metrics stay silent, never 0
    silent = {m["name"] for m in metrics if m["source"] == "device_trace" or
              getattr(harness.reader(m["name"]), "CARD_ONLY", False)}
    assert set(r["metrics"]) == {m["name"] for m in metrics} - silent
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("workload", FAULT_CELLS[:2])
def test_control_at_fewer_bits_is_not_correct(tiny, workload):
    root, manifest = tiny
    cell = harness.Cell(manifest, root, workload, "cpu")
    low = copy.deepcopy(cell.cfg)
    low["quant"]["bits"] = 8
    r = _run(tiny, workload, program_cfg=low)
    assert not r["correct"]
    assert r["checks"]["score_gap"]["value"] > 0


def _half_left_out(out):
    """Half of the batch left out, the mean of the rest in its place."""
    n = out.shape[0] // 2
    out[n:] = out[:n].to(torch.float64).mean(0).to(out.dtype)


def _one_answer_altered(out):
    out[0] += 1


FAULTS = {"half_left_out": _half_left_out, "answer_altered":
          _one_answer_altered}


@pytest.mark.parametrize("workload, fault", [
    (w, f) for w in FAULT_CELLS for f in sorted(FAULTS)] + [
    ("magic_rf_512x64_cascade.bulk", "exit_altered")])
def test_planted_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    from repro_torch.kernels import cascade_kernel, ops
    if "cascade" in workload:
        inner = cascade_kernel.cascade_qs_forward

        def broken(*a, **k):
            scores, exit_stage = inner(*a, **k)
            if fault == "exit_altered":
                exit_stage[0] = (exit_stage[0] + 1) % len(k["stage_bounds"][1:])
            else:
                FAULTS[fault](scores)
            return scores, exit_stage

        monkeypatch.setattr(cascade_kernel, "cascade_qs_forward", broken)
    else:
        inner = ops.qs_forward

        def broken(*a, **k):
            out = inner(*a, **k)
            FAULTS[fault](out)
            return out

        monkeypatch.setattr(ops, "qs_forward", broken)
    assert not _run(tiny, workload)["correct"]


GUARD = """
import json, sys
from pathlib import Path
sys.path[:0] = [{src!r}, {root!r}]
from chipbench import harness
from chipbench.tests.tiny import tiny_root
root, manifest = tiny_root(Path({tmp!r}))
r = harness.run(manifest, root, "msn1_qs_20000x64.bulk", 5, 0.2, False, "cpu")
print(json.dumps([r["correct"], harness.forbidden_modules()]))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = GUARD.format(src=str(ROOT / "src"), root=str(ROOT),
                        tmp=str(tmp_path))
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
    assert harness.forbidden_modules.__module__ == "chipbench.harness"
    for name in ("repro", "repro.core", "jax", "jaxlib.xla", "flax"):
        assert name.split(".")[0] in harness.FORBIDDEN
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "chipbench/run.py", "--workload", FAULT_CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", **(env or {})})


def test_the_command_refuses_to_run_without_a_card():
    out = _command(ROOT)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr


def test_the_command_refuses_to_run_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "chipbench", tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""
