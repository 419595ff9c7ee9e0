"""Where a predictor call's host time goes, by the program's own spans
(``repro_torch.obs.trace``), on one cell of ``BENCHMARK.json``:

    PYTHONPATH=src python scripts/torch_span_report.py --workload <cell> \\
        --seed <n> [--seconds 12] [--turns 3] [--profiled 5]

Builds the cell as ``chipbench``'s harness does, with the spans on from
before ``compile_forest``, and warms it up.  Then one caller's closed
loop over the seed's calls runs in turns of slices with the spans off
and on (no profiler; the harness's wrapper around ``transform_inputs``
on in all of them), then a slice with the spans off and one with
them on under ``torch.profiler``, as the harness's traced half runs.
Prints one JSON line:

* ``calls_per_s.off`` / ``.on`` / ``.profiled_off`` / ``.profiled`` and
  ``span_cost_pct``: calls served a second with the spans off, on, off
  under the profiler and on under it (medians of the slices), and what
  the spans cost when on (the median of the on/off ratios of adjacent
  slices); ``faults_per_call`` and ``cpu_share`` (the thread's CPU
  seconds a wall second) of the same slices;
* ``transform_ms_per_krow``: ``repro_torch.transform`` per 1000 rows,
  beside ``quantize_ms_per_krow`` (the harness's wrapper, same slices);
* ``glue_ms_per_call``: a call's ``pad`` + ``h2d`` + ``launch`` +
  ``descale`` and the root's own time (its ``predict`` span less its
  ``transform``, ``d2h`` and ``compile_arrays`` children);
* ``host_syncs_per_call``: ``d2h`` spans ÷ ``predict`` spans;
* ``coverage``: the share of the ``predict`` spans' time that their six
  children cover (``coverage_median``, ``coverage_min``: of one call);
* ``ms_per_call``: each span's mean ms a call, a child's own children
  under ``<child>.<name>`` (``transform.h2d``: the raw rows' copy where
  the card quantizes them; ``transform.host_copy``: the host's copy of
  rows the card cannot read as they are, before it);
* ``compile_arrays_s``: host builds of kernel arrays in the set-up's
  ``compile_forest`` (``.build``) and in its warm-up (``.warmup``), beside
  ``compile_s`` and ``setup_s`` as the harness reads them;
* ``profiled``: the spans-on profiled slice's ``ms_per_call`` and
  ``chipbench.devtrace.summarize``,
  the share of it with the card idle while the call thread is inside a
  span of each name (``idle_in_pct``, intervals intersected with the
  card's busy time) and ``chipbench.call``'s share of the idle seconds
  in the breakdown.
"""
from __future__ import annotations

import argparse
import json
import resource
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]

PREFIX = "repro_torch."
CHILDREN = ("transform", "pad", "h2d", "launch", "d2h", "descale")


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap(xs, ys) -> int:
    """ns in both of two merged interval lists."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_spans(events, window, thread) -> dict:
    """% of ``window`` (ns) in which the card runs nothing while
    ``thread`` is inside a span of each ``repro_torch.*`` name, at any
    depth.  ``events``: (start, end, name, on_card, thread)."""
    w0, w1 = window
    busy = _merge((max(a, w0), min(b, w1)) for a, b, _, card, _ in events
                  if card and b > w0 and a < w1)
    by_name = defaultdict(list)
    for a, b, name, card, tid in events:
        if not card and tid == thread and name.startswith(PREFIX):
            by_name[name].append((a, b))
    out = {}
    for name, spans in sorted(by_name.items()):
        inside = _merge((max(a, w0), min(b, w1)) for a, b in spans
                        if b > w0 and a < w1)
        idle = sum(b - a for a, b in inside) - _overlap(inside, busy)
        out[name[len(PREFIX):]] = 100.0 * idle / (w1 - w0)
    return out


def per_call(spans) -> dict:
    """The on-slices' readings from drained spans (module docstring)."""
    calls = defaultdict(list)
    for s in spans:
        calls[s["call"]].append(s)
    ms = defaultdict(float)
    glue, cover, n_d2h, n_root = [], [], 0, 0
    t_ns = rows = kid_ns = root_ns = 0
    for group in calls.values():
        roots = [s for s in group if s["parent"] is None]
        if len(roots) != 1 or roots[0]["name"] != PREFIX + "predict":
            continue
        root = roots[0]
        dur = root["end_ns"] - root["start_ns"]
        kids = defaultdict(int)
        kid_names = {}
        for s in group:
            if s is not root and s["parent"] == root["id"]:
                kids[s["name"][len(PREFIX):]] += s["end_ns"] - s["start_ns"]
                kid_names[s["id"]] = s["name"][len(PREFIX):]
                n_d2h += s["name"] == PREFIX + "d2h"
        for s in group:
            if s["parent"] in kid_names:
                name = f"{kid_names[s['parent']]}.{s['name'][len(PREFIX):]}"
                ms[name] += (s["end_ns"] - s["start_ns"]) / 1e6
        n_root += 1
        for name, ns in kids.items():
            ms[name] += ns / 1e6
        ms["predict"] += dur / 1e6
        glue.append(dur - kids["transform"] - kids["d2h"]
                    - kids["compile_arrays"])
        covered = sum(kids[c] for c in CHILDREN)
        cover.append(covered / dur if dur else 1.0)
        kid_ns += covered
        root_ns += dur
        t_ns += kids["transform"]
        rows += root.get("rows", 0)
    if not n_root:
        return {}
    return {"calls": n_root,
            "transform_ms_per_krow": t_ns / 1e6 / (rows / 1e3),
            "glue_ms_per_call": float(np.mean(glue)) / 1e6,
            "host_syncs_per_call": n_d2h / n_root,
            "coverage": kid_ns / root_ns,
            "coverage_median": float(np.median(cover)),
            "coverage_min": float(min(cover)),
            "ms_per_call": {k: v / n_root for k, v in sorted(ms.items())}}


def report(workload: str, seed: int, seconds: float, profiled: float,
           device: str, turns: int, root: Path = ROOT) -> dict:
    from chipbench import devtrace, harness, mix, program
    from repro_torch.obs import trace

    t_start = time.perf_counter()
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    trace.enable(True)
    trace.drain()
    dropped = trace.dropped()
    cell = harness.Cell(manifest, root, workload, device)
    build_spans = trace.drain()
    pred = cell.pred
    calls = mix.calls(cell.mix, cell.dataset, seed)
    quantize: list = []
    program.time_transform(pred, quantize)
    warm = {}
    for X in calls:
        key = program.padded_rows(pred, len(X))
        if len(X) > len(warm.get(key, ())):
            warm[key] = X
    for X in list(warm.values()) + calls[:3]:
        pred.predict(X)
    sync = torch.cuda.synchronize if cell.on_card else (lambda: None)
    sync()
    warm_spans = trace.drain()
    setup_s = time.perf_counter() - t_start
    quantize.clear()

    state = {"i": 0}
    rates, faults, cpu = (defaultdict(list) for _ in range(3))

    def loop(key, secs, span=None):
        """Calls a second over ``secs``; the slice's minor page faults a
        call and the thread's CPU seconds a wall second go beside it."""
        n, t0, c0 = 0, time.perf_counter(), time.thread_time()
        f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt
        while time.perf_counter() - t0 < secs:
            X = calls[state["i"] % len(calls)]
            state["i"] += 1
            if span is None:
                pred.predict(X)
            else:
                with span("chipbench.call"):
                    pred.predict(X)
            n += 1
        wall = time.perf_counter() - t0
        rates[key].append(n / wall)
        faults[key].append(
            (resource.getrusage(resource.RUSAGE_SELF).ru_minflt - f0) / n)
        cpu[key].append((time.thread_time() - c0) / wall)

    on_spans, on_quantize = [], []
    for _ in range(turns):
        for key in ("off", "on"):
            trace.enable(key == "on")
            loop(key, seconds / (2 * turns))
            if key == "on":
                on_spans += trace.drain()
                on_quantize += quantize
            quantize.clear()
    trace.enable(True)
    q_s = sum(s for s, _ in on_quantize)
    q_rows = sum(n for _, n in on_quantize)
    del pred.transform_inputs           # the harness's second half
    trace.enable(False)                 # as the harness profiles today
    with devtrace.profiler(cell.device):
        loop("profiled_off", profiled, torch.profiler.record_function)
        sync()
    trace.enable(True)
    with devtrace.profiler(cell.device) as prof:
        with torch.profiler.record_function(devtrace.WINDOW):
            loop("profiled", profiled, torch.profiler.record_function)
        sync()
    trace.enable(False)
    profiled_calls = per_call(trace.drain())
    events, window, thread = [], None, None
    for e in prof.profiler.kineto_results.events():
        on_cpu = e.device_type() == torch.autograd.DeviceType.CPU
        if on_cpu and e.name() == devtrace.WINDOW:
            window = (e.start_ns(), e.end_ns())
        elif on_cpu and e.name() == "chipbench.call" and thread is None:
            thread = e.start_thread_id()
        if on_cpu or not e.is_user_annotation():
            events.append((e.start_ns(), e.end_ns(), e.name(), not on_cpu,
                           e.start_thread_id()))
    summary = devtrace.summarize(prof)
    prof_out = {"summary": summary,
                "ms_per_call": profiled_calls.get("ms_per_call")}
    gaps = summary.get("breakdown", {}).get("idle_gaps", [])
    if "busy_s" in summary:
        idle_s = summary["window_s"] - summary["busy_s"]
        prof_out["idle_in_pct"] = idle_in_spans(events, window, thread)
        prof_out["call_share_of_idle_pct"] = 100.0 * sum(
            s for n, s in gaps if n == "chipbench.call") / idle_s
    out = {"workload": workload, "seed": seed,
           "device": torch.cuda.get_device_name() if cell.on_card
           else "cpu",
           "setup_s": setup_s, "compile_s": cell.compile_s,
           "compile_arrays_s": {
               k: sum(s["end_ns"] - s["start_ns"] for s in spans
                      if s["name"] == PREFIX + "compile_arrays") / 1e9
               for k, spans in (("build", build_spans),
                                ("warmup", warm_spans))},
           "calls_per_s": {k: float(np.median(v)) for k, v in rates.items()},
           "calls_per_s_slices": rates,
           "faults_per_call": {k: float(np.median(v))
                               for k, v in faults.items()},
           "cpu_share": {k: float(np.median(v)) for k, v in cpu.items()},
           "span_cost_pct": 100.0 * (1 - float(np.median(
               np.divide(rates["on"], rates["off"])))),
           "quantize_ms_per_krow": q_s * 1e3 / (q_rows / 1e3)
           if q_rows else None,
           "dropped": trace.dropped() - dropped,
           **per_call(on_spans), "profiled": prof_out}
    cell.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=12.0,
                    help="spans-off and spans-on slices together")
    ap.add_argument("--turns", type=int, default=3,
                    help="pairs of spans-off and spans-on slices")
    ap.add_argument("--profiled", type=float, default=5.0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    print(json.dumps(report(args.workload, args.seed, args.seconds,
                            args.profiled, "cuda", args.turns)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main())
