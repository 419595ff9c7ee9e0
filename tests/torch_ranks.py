"""Rank programs of ``tests/test_torch_dp.py`` and the harness that spawns
them: one process per rank of a gloo group on the CPU, the rendezvous
through a file store in the test's temp dir (no ports, so no races under
xdist), an explicit collective timeout and a join timeout, so a hung
collective fails its test.  A spawned child imports this module, not the
test file, so it imports neither jax nor the reference."""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np

JOIN_TIMEOUT_S = 120.0
COLLECTIVE_TIMEOUT_S = 60.0
SEQ = 32
PSUM_SHAPE = (4, 8, 16)          # (ranks, rows, cols)
# (name, Trainer keywords, steps) of the data-parallel runs
DP_CASES = (("f32", {}, 4),
            ("compress", {"compress_grads": True}, 3),
            ("int8", {"opt_state": "int8"}, 3))
DP_BATCH = 8


def _entry(fn, rank, world, store, args, results):
    os.environ.update(REPRO_COORDINATOR=f"file://{store}",
                      REPRO_NUM_PROCESSES=str(world),
                      REPRO_PROCESS_ID=str(rank))
    import torch
    torch.set_num_threads(1)
    try:
        results.put((rank, True, fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 — carried to the test
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, store: str, *args,
              timeout_s: float = JOIN_TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes with the
    REPRO_* variables of a file-store rendezvous at ``store``; their
    results by rank.  Raises on an error in any rank or on the timeout."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                missing = sorted(set(range(world)) - set(out))
                raise TimeoutError(f"ranks {missing} gave no result in "
                                   f"{timeout_s} s")
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def psum_inputs():
    """Every rank's gradient and residual for ``compressed_psum``."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=PSUM_SHAPE).astype(np.float32)
    r = (rng.normal(size=PSUM_SHAPE) * 0.01).astype(np.float32)
    return g, r


def _cfg():
    from repro_torch.configs import get_config
    return get_config("smollm_360m").reduced()


def trainer(batch, mesh=None, **kw):
    import torch
    from repro_torch.launch.train import Trainer
    return Trainer(_cfg(), batch=batch, seq_len=SEQ, mesh=mesh,
                   compute_dtype=torch.float32, device="cpu", **kw)


def _records(recs):
    return [(r["loss"], r["grad_norm"]) for r in recs]


def four_ranks(rank, world, tmp):
    """The 4-rank scenario: the REPRO_* rendezvous, a (4, 1) mesh and its
    groups, ``compressed_psum`` on this rank's slice, the data-parallel
    runs (the f32 one through ``run_loop`` with a checkpoint at step 2, a
    heartbeat and the log), a (2, 2, 1) pod mesh on an indivisible batch,
    and a (2, 2) mesh's refusal."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.compression import compressed_psum
    from repro_torch.launch.cluster import host_info, initialize_from_env
    from repro_torch.launch.mesh import Mesh, make_debug_mesh
    from repro_torch.launch.train import run_loop
    from repro_torch.models.model import tree_flatten
    from torch.distributed.device_mesh import init_device_mesh

    initialize_from_env(device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    mesh = make_debug_mesh(4, 1, device="cpu")
    out = {"info": host_info(), "backend": dist.get_backend(),
           "shape": mesh.shape, "coord": mesh.coordinate("data"),
           "data_group": dist.get_world_size(mesh.group("data")),
           "model_group": dist.get_world_size(mesh.group("model"))}
    g, r = psum_inputs()
    with mesh:
        o, nr = compressed_psum(torch.from_numpy(g[rank]),
                                torch.from_numpy(r[rank]), "data")
    out["psum"] = (o.numpy(), nr.numpy())

    for name, kw, steps in DP_CASES:
        tr = trainer(DP_BATCH, mesh, **kw)
        if name == "f32":
            recs = run_loop(tr, steps=2, ckpt_dir=f"{tmp}/ck", ckpt_every=2,
                            log_path=f"{tmp}/log.jsonl", hb_dir=f"{tmp}/hb")
        else:
            tr.init_state()
            recs = []
        recs += [tr.train_step() for _ in range(steps - len(recs))]
        out[name] = _records(recs)
        out[name + "_rows"] = (tr._first_row, tr.rows_per_rank)
        out[name + "_comm"] = {k: recs[-1][k] for k in
                               ("all_reduce_bytes", "grad_bytes",
                                "replicas")}
        out[name + "_params"] = [p.numpy() for p in
                                 tree_flatten(tr.params)[0][:3]]
    pod = Mesh({"pod": 2, "data": 2, "model": 1},
               init_device_mesh("cpu", (2, 2, 1),
                                mesh_dim_names=("pod", "data", "model")),
               torch.device("cpu"))
    tr = trainer(6, pod)
    tr.init_state()
    out["pod"] = _records([tr.train_step() for _ in range(3)])
    out["pod_rows"] = (tr.tok_spec, tr._first_row, tr.rows_per_rank)
    try:
        trainer(DP_BATCH, make_debug_mesh(2, 2, device="cpu"))
    except NotImplementedError as e:
        out["tp_error"] = str(e)
    return out


def two_ranks(rank, world, tmp, accum):
    """The 2-rank scenario: restore the 4-replica checkpoint with the
    elastic plan's accumulation and train on; then the launcher itself,
    REPRO_MULTIHOST=1, on a second rendezvous."""
    from repro_torch.launch import train
    from repro_torch.launch.cluster import initialize_from_env
    from repro_torch.launch.mesh import make_debug_mesh

    initialize_from_env(device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    tr = trainer(DP_BATCH, make_debug_mesh(2, 1, device="cpu"),
                 accum_steps=accum)
    step = tr.restore(f"{tmp}/ck")
    out = {"step": step, "restored": _records(
        [tr.train_step() for _ in range(2)]),
           "rows": (tr._first_row, tr.rows_per_rank)}
    import torch.distributed as dist
    dist.destroy_process_group()
    os.environ.update(REPRO_MULTIHOST="1",
                      REPRO_COORDINATOR=f"file://{tmp}/store_cli")
    recs = train.main(["--reduced", "--steps", "2", "--batch", "4",
                       "--seq-len", str(SEQ), "--ckpt-dir", f"{tmp}/cli",
                       "--hb-dir", f"{tmp}/cli_hb", "--log",
                       f"{tmp}/cli.jsonl", "--device", "cpu"])
    out["cli"] = recs
    out["cli_after"] = dist.is_initialized()
    return out
