"""Reading the profiler's trace of a window: device busy time, kernel
time, the device operations that took most time and the idle gaps by
what the host was doing.

Spans of the harness's own (``torch.profiler.record_function``):
``chipbench.window`` around the measured window, ``chipbench.call``
around each call into the program and ``chipbench.quantize`` around the
predictor's ``transform_inputs`` in a traced run.  Device activity is
every kernel, copy and memset the trace shows on the card."""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity

WINDOW = "chipbench.window"
TOP = 10


def profiler(device: torch.device):
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(prof) -> dict:
    """Seconds of the traced window (``window_s``), of device activity in
    it (``busy_s``) and of kernels alone (``kernel_s``), and the
    ``breakdown`` lists.  Without a window span or device activity the
    device numbers are None."""
    host, device = [], []
    window = None
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns(), e.end_ns()
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() == WINDOW:
                window = (a, b)
            else:
                host.append((a, b, e.name(), e.start_thread_id()))
        elif not e.is_user_annotation():    # a span's shadow on the card
            device.append((a, b, e.name()))
    if window is None:
        return {}
    w0, w1 = window
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    out = {"window_s": (w1 - w0) / 1e9}
    if not inside:
        return out
    by_name = defaultdict(int)
    kernel_ns = 0
    for a, b, n in inside:
        by_name[n] += b - a
        if not n.startswith(("Memcpy", "Memset")):
            kernel_ns += b - a
    busy = _merge((a, b) for a, b, _ in inside)
    out["busy_s"] = sum(b - a for a, b in busy) / 1e9
    out["kernel_s"] = kernel_ns / 1e9
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    out["breakdown"] = {
        "device_ops": _top((n, ns / 1e9) for n, ns in by_name.items()),
        "idle_gaps": _top(_label_gaps(gaps, host, w0, w1))}
    return out


def _top(pairs):
    return [[n, s] for n, s in sorted(pairs, key=lambda p: -p[1])[:TOP]]


def _label_gaps(gaps, host, w0, w1):
    """Idle seconds by the innermost host operation of the window's
    thread that covers each gap's middle."""
    thread = next((tid for a, b, n, tid in host
                   if n == "chipbench.call"), None)
    ops = sorted((a, b, n) for a, b, n, tid in host
                 if tid == thread and b > w0 and a < w1)
    seconds = defaultdict(float)
    stack, j = [], 0           # the ops of one thread nest: a stack sweep
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(ops) and ops[j][0] <= mid:
            while stack and stack[-1][1] < ops[j][0]:
                stack.pop()
            stack.append(ops[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "outside any host operation"
        seconds[label] += (g1 - g0) / 1e9
    return seconds.items()
