"""Multi-process cluster bring-up — the port's counterpart of
``repro.launch.cluster``.

Every process runs the same command, one process per device:

    REPRO_MULTIHOST=1 REPRO_COORDINATOR=host0:29500 \\
    REPRO_NUM_PROCESSES=4 REPRO_PROCESS_ID=$RANK \\
    python -m repro_torch.launch.train --arch smollm_360m --ckpt-dir DIR \\
        --hb-dir DIR/hb

``initialize_from_env()`` (called by the launchers when REPRO_MULTIHOST=1)
is ``torch.distributed.init_process_group`` with the reference's
variables: NCCL for processes on the card, gloo when the caller asks for
the CPU, and an explicit timeout, so a collective that waits on a lost
peer fails instead of hanging.  Nothing discovers peers by itself here,
so the three variables (or arguments) are required.

Failure/restart protocol:
  1. every process heartbeats (``fault_tolerance.Heartbeat``) each step;
  2. the job runner restarts dead processes; on restart the launcher
     resumes from the newest complete checkpoint (atomic rename ⇒ never a
     torn read; rank 0 writes it, every rank reads it);
  3. if the replacement capacity is smaller, ``plan_elastic_restart``
     shrinks the data-parallel axis to the largest power of two ≤ the
     survivors and raises ``--accum-steps`` so the global batch (and the
     loss trajectory) is unchanged.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from ..core.registry import resolve_device
from .mesh import BACKENDS

DEFAULT_TIMEOUT_S = 600.0


def multihost_requested() -> bool:
    return os.environ.get("REPRO_MULTIHOST", "0") == "1"


def init_method(coordinator: str) -> str:
    """``host:port`` → ``tcp://host:port``; a URL (``tcp://``,
    ``file://``) is taken as it is."""
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def initialize_from_env(coordinator: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None, *,
                        device=None,
                        timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group: the arguments, else REPRO_COORDINATOR
    (host:port), REPRO_NUM_PROCESSES and REPRO_PROCESS_ID.  Returns this
    rank's device: on the card ``cuda:(rank % visible cards)``, made the
    current device."""
    dev = resolve_device(device)
    coordinator = coordinator or os.environ.get("REPRO_COORDINATOR")
    n = num_processes or os.environ.get("REPRO_NUM_PROCESSES")
    pid = process_id if process_id is not None \
        else os.environ.get("REPRO_PROCESS_ID")
    if not coordinator or n is None or pid is None:
        raise ValueError("initialize_from_env needs a coordinator, the "
                         "number of processes and this process's id "
                         "(REPRO_COORDINATOR, REPRO_NUM_PROCESSES, "
                         "REPRO_PROCESS_ID)")
    n, pid = int(n), int(pid)
    backend = BACKENDS.get(dev.type)
    if backend is None:
        raise ValueError(f"no process group backend for {dev.type}")
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", pid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(
        backend, init_method=init_method(coordinator), world_size=n,
        rank=pid, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return dev


def host_info() -> dict:
    """This process's place in the cluster: its rank, the world size, the
    devices it drives (one) and the devices of the job (one per rank)."""
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {
        "process_index": dist.get_rank() if up else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
