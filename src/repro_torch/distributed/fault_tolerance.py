"""Fault-tolerance machinery: heartbeats, straggler detection, elastic
restart planning — the port's copy of ``repro.distributed.fault_tolerance``
(pure Python, line for line the reference's behaviour).

On a real multi-host cluster each component runs per process; the CPU
container exercises the same code paths single-host (unit-tested state
machines + file protocols). The design targets 1000+ nodes:

  * Heartbeat files are O(1) per host per step — a shared filesystem (or
    object store) scales to thousands of writers because each host touches
    only its own file.
  * The straggler detector is purely local math over observed step times
    (trailing median + multiplier), no coordination.
  * The elastic planner maps surviving host sets onto the largest usable
    mesh (DP axis shrink in powers of two) so restore-after-failure keeps
    every surviving chip busy instead of stalling the fleet.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence


# --------------------------------------------------------------------------- #
# Heartbeats
# --------------------------------------------------------------------------- #
class Heartbeat:
    """Per-process liveness file: ``<dir>/host_<idx>.hb`` containing the last
    step and wall time. Atomic via write-to-tmp + rename."""

    def __init__(self, directory: str, proc_index: int):
        self.dir = directory
        self.idx = proc_index
        os.makedirs(directory, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.dir, f"host_{self.idx:05d}.hb")

    def beat(self, step: int, now: Optional[float] = None) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "time": now or time.time()}, f)
        os.replace(tmp, self.path)

    @staticmethod
    def survey(directory: str, timeout_s: float,
               now: Optional[float] = None) -> dict[int, dict]:
        """All hosts' heartbeats; entries older than ``timeout_s`` are marked
        dead. Returns {proc_index: {"step", "time", "alive"}}."""
        now = now or time.time()
        out: dict[int, dict] = {}
        if not os.path.isdir(directory):
            return out
        for name in sorted(os.listdir(directory)):
            if not (name.startswith("host_") and name.endswith(".hb")):
                continue
            idx = int(name[5:10])
            try:
                with open(os.path.join(directory, name)) as f:
                    rec = json.load(f)
            except (json.JSONDecodeError, OSError):
                out[idx] = {"step": -1, "time": 0.0, "alive": False}
                continue
            rec["alive"] = (now - rec["time"]) <= timeout_s
            out[idx] = rec
        return out


# --------------------------------------------------------------------------- #
# Straggler detection
# --------------------------------------------------------------------------- #
@dataclass
class StragglerDetector:
    """Trailing-median step-time watchdog.

    A step slower than ``multiplier ×`` the trailing median is flagged.
    ``grace`` initial steps are ignored (compile + warmup).
    """
    window: int = 32
    multiplier: float = 3.0
    grace: int = 2
    _times: deque = field(default_factory=deque)
    _seen: int = 0

    def observe(self, step_time_s: float) -> bool:
        """Record one step; returns True if this step is a straggler."""
        self._seen += 1
        if self._seen <= self.grace:
            return False
        is_straggler = False
        if len(self._times) >= 4:
            med = sorted(self._times)[len(self._times) // 2]
            is_straggler = step_time_s > self.multiplier * med
        # stragglers don't poison the window
        if not is_straggler:
            self._times.append(step_time_s)
            if len(self._times) > self.window:
                self._times.popleft()
        return is_straggler

    @property
    def median(self) -> Optional[float]:
        if not self._times:
            return None
        return sorted(self._times)[len(self._times) // 2]

    def deadline(self) -> Optional[float]:
        m = self.median
        return None if m is None else self.multiplier * m


# --------------------------------------------------------------------------- #
# Elastic restart planning
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ElasticPlan:
    n_hosts_alive: int
    dp_size: int                 # new data-parallel axis size
    dropped_hosts: tuple         # hosts excluded from the new mesh
    global_batch: int            # preserved (grad-accum absorbs the shrink)
    accum_steps: int             # microbatches per step on the shrunk mesh


def plan_elastic_restart(alive: Sequence[int], total_hosts: int,
                         dp_size: int, global_batch: int) -> ElasticPlan:
    """Shrink the DP axis to the largest power-of-two ≤ alive hosts
    (model axes stay intact: a host loss removes whole DP replicas).
    The global batch is preserved by gradient accumulation, so the loss
    trajectory is unchanged — only wall-clock throughput drops.
    """
    n_alive = len(alive)
    assert n_alive >= 1, "no survivors"
    new_dp = 1
    while new_dp * 2 <= min(n_alive, dp_size):
        new_dp *= 2
    used = sorted(alive)[:new_dp]
    dropped = tuple(h for h in range(total_hosts) if h not in used)
    accum = max(1, dp_size // new_dp)
    return ElasticPlan(n_alive, new_dp, dropped, global_batch, accum)


# --------------------------------------------------------------------------- #
# Preemption flag (SIGTERM → checkpoint-and-exit handshake)
# --------------------------------------------------------------------------- #
class PreemptionFlag:
    """Co-operative shutdown: signal handlers set it, the train loop polls
    it at step boundaries (async-signal-safe: just a bool)."""

    def __init__(self):
        self._flag = False

    def set(self, *_args) -> None:
        self._flag = True

    def __bool__(self) -> bool:
        return self._flag
