"""Which parts of the port's training step reproduce bit for bit on a CUDA
card, and what PyTorch's deterministic kernels cost there.

For a reduced config of each family (4 × 64 tokens) and for smollm-360m
at full width (8 × 256 and 4 × 4096 tokens) it computes the trainer's loss
and gradients (``Trainer._grads``: bf16 compute, f32 masters,
``backend="torch"``) three times from one state in PyTorch's default mode,
then three times under ``launch.train.reproducible`` (which turns on
``torch.use_deterministic_algorithms``), and prints for each mode the
gradient leaves that differ between the repeats, the distinct losses, the
warnings of any op without a deterministic kernel (``warn_only`` while
probing), and the time of each pass.  At 4 × 4096 it also times whole
``Trainer.train_step`` calls in turns (A, B, C, C, B, A, twice) under
PyTorch's default mode, under ``reproducible`` (deterministic kernels, no
NaN fill of fresh memory) and under the deterministic mode with its NaN
fill, and profiles one step in the default mode and one under
``reproducible`` with ``torch.profiler``: the device's busy time and the
operators whose kernels take the most of it.  Run from
the repository root on the card:

    PYTHONPATH=src python scripts/torch_train_determinism.py
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import warnings

import torch

from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.launch.train import Trainer
from repro_torch.models.model import tree_flatten

REPEATS = 3
# (config, reduced, batch, sequence length)
CASES = [("smollm_360m", True, 4, 64), ("phi3_5_moe_42b", True, 4, 64),
         ("mamba2_370m", True, 4, 64), ("jamba_1_5_large_398b", True, 4, 64),
         ("seamless_m4t_large_v2", True, 4, 64),
         ("smollm_360m", False, 8, 256), ("smollm_360m", False, 4, 4096)]


def leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k],
                                                            f"{prefix}/{k}")]
    return [prefix]


@contextlib.contextmanager
def mode(deterministic: bool):
    """PyTorch's default kernels, or deterministic ones with a warning
    (not an error) for an op that has none, so the probe lists them."""
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def probe(name, reduced, B, S, device) -> dict:
    cfg = get_config(name)
    cfg = cfg.reduced() if reduced else cfg
    tr = Trainer(cfg, batch=B, seq_len=S, device=device)
    tr.init_state(0)
    names = leaf_names(tr.params)
    tokens, enc = tr.batch_inputs(0)
    out = {"config": cfg.name, "batch": B, "seq_len": S}
    for det in (False, True):
        runs, times = [], []
        with mode(det), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(REPEATS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, grads = tr._grads(tokens, enc)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                runs.append((float(loss), tree_flatten(grads)[0]))
        differ = sorted({n for _, g in runs[1:] for n, a, b in
                         zip(names, runs[0][1], g) if not torch.equal(a, b)})
        out["deterministic" if det else "default"] = {
            "leaves_differ": differ,
            "distinct_losses": len({loss for loss, _ in runs}),
            "warnings": sorted({str(w.message)[:200] for w in caught}),
            # the first pass of the first mode carries the warm-up
            "grads_ms": [round(t * 1e3, 2) for t in times]}
        del runs
    if not reduced and S >= 4096:
        out["train_step_ms"] = step_turns(tr)
        out["profile"] = {m: step_profile(tr, m)
                          for m in ("default", "reproducible")}
    del tr
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def deterministic_fill(device):
    """The deterministic mode as PyTorch sets it, NaN fill included."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


TURNS = ("default", "reproducible", "deterministic_fill",
         "deterministic_fill", "reproducible", "default") * 2


def step_modes() -> dict:
    """The three ways to run a step, each a stand-in for
    ``train.reproducible``: PyTorch's default mode, ``reproducible``
    itself, and the deterministic mode with its NaN fill."""
    return {"default": lambda device: contextlib.nullcontext(),
            "reproducible": train.reproducible,
            "deterministic_fill": deterministic_fill}


def step_turns(tr) -> dict:
    """Whole train steps in turns (A, B, C, C, B, A, twice), each mode put
    in place of ``train.reproducible`` for its steps."""
    real, modes = train.reproducible, step_modes()
    got = {m: [] for m in modes}
    try:
        for m in TURNS:
            train.reproducible = modes[m]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.train_step()
            torch.cuda.synchronize()
            got[m].append(round((time.perf_counter() - t0) * 1e3, 2))
    finally:
        train.reproducible = real
    return got


def step_profile(tr, mode: str, top: int = 12) -> dict:
    """One train step in ``mode`` under ``torch.profiler``: its wall ms,
    the device's busy ms (the sum of the kernels' device time), and the
    ``top`` operators by the device time of the kernels each launched
    itself (self device time; a kernel counts once, under the operator
    that launched it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    real = train.reproducible
    train.reproducible = step_modes()[mode]
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.train_step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        train.reproducible = real
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    ops = sorted((e for e in events if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": round(wall, 1), "device_busy_ms": round(busy, 1),
            "ops": {e.key: [e.count, round(e.self_device_time_total / 1e3,
                                           1)] for e in ops[:top]}}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_determinism: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"card {card}")
    device = torch.device("cuda")
    for case in CASES:
        print(json.dumps(probe(*case, device)), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
