"""One run of one cell: set-up, warm-up, the measured window, the check
against the plain reference, and the result line.

``main`` is the command line; it refuses to run without the cards a
cell asks for, and refuses to print a result if JAX or the JAX package
was loaded.  ``run`` does the rest on any device, which lets the tests
drive a whole run on the CPU at a tiny size."""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import datasets, devtrace, mix, models, program, reference, yardstick

# top-level module names no run may load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HERE = Path(__file__).resolve().parent


def _no_span(name):
    return contextlib.nullcontext()


def forbidden_modules() -> list:
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def reader(name: str):
    """The module of a metric: ``metrics/<name>.py``, else
    ``metrics/<quantity>.py`` for a name ``<quantity>.<split>``.  Its
    ``read(ctx)`` gives the value or None; ``CARD_ONLY = True`` marks one
    that a run off the card leaves out (a share of the H100's peak)."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.exists():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"chipbench.metrics.{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(manifest: dict, workload: str, traced: bool) -> list:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    untraced, the per-layer ones traced."""
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in
                                 names else [])]


class Cell:
    """One cell's set-up: its configuration, mix, model file and the
    program compiled from it.  ``program_cfg`` builds the program from
    another configuration than the cell's (the control: the same model at
    fewer bits), while the check still holds it to the cell's."""

    def __init__(self, manifest: dict, root: Path, workload: str,
                 device="cuda", program_cfg: dict | None = None):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            torch.cuda.reset_peak_memory_stats()
        self.manifest, self.workload = manifest, workload
        wl = _entry(manifest["workloads"], workload, "workload")
        cfg_path = Path(root) / _entry(manifest["configs"], wl["config"],
                                       "config")["file"]
        self.cfg = json.loads(cfg_path.read_text())
        self.mix = json.loads((Path(root) / "chipbench" / "traffic" /
                               f"{wl['traffic']}.json").read_text())
        self.dataset = datasets.load(self.cfg["dataset"])
        self.model = models.load(self.cfg, cfg_path, root)
        self.train_rows, _ = self.dataset.train_rows()
        self.pred, self.compile_s = program.build(
            self.model, program_cfg or self.cfg, self.train_rows,
            self.device)

    def close(self) -> None:
        """Free the program's state before the reference runs."""
        self.pred = None
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def measure(self, seed: int, seconds: float, traced: bool,
                t_start: float) -> SimpleNamespace:
        """Warm up on the seed's calls, then one caller's closed loop over
        them for ``seconds``; keeps the first and the last answer to each
        call of the pool."""
        pred = self.pred
        calls = mix.calls(self.mix, self.dataset, seed)
        quantize_spans: list = []
        if traced:
            program.time_transform(pred, quantize_spans)
        warm = {}                       # the largest call of each shape
        for X in calls:
            key = program.padded_rows(pred, len(X))
            if len(X) > len(warm.get(key, ())):
                warm[key] = X
        for X in list(warm.values()) + calls[:3]:
            pred.predict(X)
        quantize_spans.clear()
        if self.on_card:
            torch.cuda.synchronize()
        n = len(calls)
        w = SimpleNamespace(
            calls=calls, first=[None] * n, last=[None] * n,
            first_counts=[None] * n, last_counts=[None] * n,
            served=np.zeros(n, dtype=np.int64), latencies=[], failed=0,
            rows=0, attempted=0, exit_counts=None, quantize=quantize_spans,
            trace={}, traced_served=None)
        w.setup_s = time.perf_counter() - t_start
        if not traced:
            w.seconds, w.window_rows = self._loop(w, seconds, _no_span)
            w.untraced_served = w.served
        else:
            # the first half with the transform's clock alone, the second
            # under the profiler, which slows the host's side
            w.seconds, w.window_rows = self._loop(w, seconds / 2, _no_span)
            del pred.transform_inputs           # the instance's wrapper
            untraced = w.served.copy()
            with devtrace.profiler(self.device) as prof:
                with torch.profiler.record_function(devtrace.WINDOW):
                    self._loop(w, seconds / 2, torch.profiler.record_function)
            w.trace = devtrace.summarize(prof)
            w.untraced_served = untraced
            w.traced_served = w.served - untraced
        w.memory_peak = torch.cuda.max_memory_allocated() \
            if self.on_card else 0
        return w

    def _loop(self, w: SimpleNamespace, seconds: float, span):
        """One caller's closed loop over the pool for ``seconds``: each call
        starts when the last returned.  Returns the loop's seconds and
        rows; latencies and answers go into ``w``."""
        pred, calls = self.pred, w.calls
        rows0 = w.rows
        w0 = time.perf_counter()
        deadline = w0 + seconds
        i = w.attempted
        while True:
            k = i % len(calls)
            t0 = time.perf_counter()
            try:
                with span("chipbench.call"):
                    out = pred.predict(calls[k])
            except Exception as exc:          # a call that never answers
                w.failed += 1
                print(f"call {i} failed: {exc!r}", file=sys.stderr)
                out = None
            t1 = time.perf_counter()
            w.latencies.append(t1 - t0)
            if out is not None:
                w.rows += len(calls[k])
                w.served[k] += 1
                counts = program.exit_counts(pred)
                if w.first[k] is None:
                    w.first[k], w.first_counts[k] = out, counts
                w.last[k], w.last_counts[k] = out, counts
                if counts is not None:
                    w.exit_counts = counts if w.exit_counts is None \
                        else w.exit_counts + counts
            i += 1
            if t1 >= deadline:
                break
        w.attempted = i
        return t1 - w0, w.rows - rows0

    def judge(self, w: SimpleNamespace, traced: bool) -> dict:
        """Check the window's answers against the plain reference and
        read the cell's metrics; returns the result line as a dict."""
        cfg = self.cfg
        checks, work = check(self.model, cfg, self.train_rows, w,
                             self.device)

        def least(served):
            """The yardstick's least time for the calls ``served``."""
            if served is None:
                return None
            return yardstick.least_seconds(
                sum(op * n for (op, _), n in zip(work, served)),
                sum(nb * n for (_, nb), n in zip(work, served)))

        limits = cfg["limits"]
        correct = w.failed == 0 and bool(w.served.any()) and all(
            checks[name] <= limits[name] for name in limits)
        ctx = SimpleNamespace(
            setup_s=w.setup_s, compile_s=self.compile_s, seconds=w.seconds,
            rows=w.window_rows, latencies=np.asarray(w.latencies),
            quantize=w.quantize, exit_counts=w.exit_counts,
            stages=cfg.get("cascade", {}).get("stages"),
            least_s=least(w.untraced_served),
            trace_least_s=least(w.traced_served), trace=w.trace)
        metrics = {}
        for m in cell_metrics(self.manifest, self.workload, traced):
            module = reader(m["name"])
            if getattr(module, "CARD_ONLY", False) and not self.on_card:
                continue
            value = module.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev = {"platform": "gpu" if self.on_card else self.device.type,
               "kind": torch.cuda.get_device_name(self.device)
               if self.on_card else "cpu",
               "count": 1, "memory_peak_bytes": int(w.memory_peak)}
        if traced:
            dev["busy_s"] = w.trace.get("busy_s", 0.0)
            dev["window_s"] = w.trace.get("window_s", w.seconds)
        result = {"correct": bool(correct), "attempted": w.attempted,
                  "failed": w.failed, "metrics": metrics, "device": dev}
        if "breakdown" in w.trace:
            result["breakdown"] = w.trace["breakdown"]
        result["checks"] = {name: {"value": float(checks[name]),
                                   "limit": float(limits[name])}
                            for name in limits}
        return result


def run(manifest: dict, root: Path, workload: str, seed: int,
        seconds: float, traced: bool, device="cuda",
        t_start: float | None = None) -> dict:
    """One run of ``workload``: set-up, the window, the program's state
    freed (after its memory peak is read), then the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(manifest, root, workload, device)
    w = cell.measure(seed, seconds, traced, t_start)
    cell.close()
    return cell.judge(w, traced)


def check(model, cfg, train_rows, w, device):
    """Compare every output the window kept — the first and the last
    answer to each call of the pool — with the plain reference on the
    same rows.  Returns ({name: reading}, [(ops, bytes) per call])."""
    q = reference.quantize_model(model, train_rows, cfg["quant"]["bits"])
    C = q.leaf.shape[-1]
    d = int(model["n_features"])
    casc = cfg.get("cascade")
    stages = casc["stages"] if casc else [q.n_trees]
    nodes = np.concatenate([[0], np.cumsum(model["n_nodes"])])
    leaves = np.concatenate([[0], np.cumsum(model["n_leaves"])])
    thr_bytes = (cfg["quant"]["bits"] + 7) // 8
    # one reference pass over every call's rows, split back per call
    calls = w.calls
    xq = q.rows(np.concatenate(calls))
    if casc:
        sums, exit_stage, compares = reference.cascade(
            q, xq, stages, float(model["gate_threshold"]), device)
    else:
        sums, compares = reference.traverse(q, xq, device=device)
        exit_stage = np.zeros(len(xq), dtype=np.int64)
    cuts = np.cumsum([len(X) for X in calls])[:-1]
    score_gap, count_gap, work = 0.0, 0, []
    for k, (ref, ex, comp) in enumerate(zip(
            np.split(q.descale(sums), cuts), np.split(exit_stage, cuts),
            np.split(compares, cuts))):
        ref_counts = np.bincount(ex, minlength=len(stages))
        for out, counts in ((w.first[k], w.first_counts[k]),
                            (w.last[k], w.last_counts[k])):
            if out is None:
                continue
            score_gap = max(score_gap, _gap(out, ref))
            if casc:
                count_gap = max(count_gap, np.inf if counts is None else
                                int(np.abs(counts - ref_counts).sum()))
        walked = np.asarray(stages)[ex]
        reach = int(walked.max()) if len(ex) else 0
        model_bytes = yardstick.forest_bytes(
            int(nodes[reach]), int(leaves[reach]), C, thr_bytes, 4)
        work.append(yardstick.call_work(len(ex), d, C, int(comp.sum()),
                                        int(walked.sum()), model_bytes))
    checks = {"score_gap": score_gap}
    if casc:
        checks["exit_count_gap"] = count_gap
    return checks, work


def _gap(out, ref) -> float:
    """The widest |port - reference| over the rows; inf if the port's
    answer has another shape or a NaN."""
    out = np.asarray(out)
    if out.shape != ref.shape:
        return float("inf")
    diff = np.abs(out.astype(np.float64) - ref.astype(np.float64))
    return float(np.where(np.isnan(diff), np.inf, diff).max(initial=0.0))


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = HERE.parent
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    chips = _entry(manifest["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available: no run",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run(manifest, root, args.workload, args.seed, args.seconds,
                 bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
