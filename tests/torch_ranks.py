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
              timeout_s: float = JOIN_TIMEOUT_S, during=None) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes with the
    REPRO_* variables of a file-store rendezvous at ``store``; their
    results by rank.  ``during()`` runs in this process while they do.
    Raises on an error in any rank or on the timeout."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, store, args, results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout_s
    try:
        if during is not None:
            during()
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
    and a (2, 2) mesh, "model" = 2."""
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
        out[name + "_params"] = [
            p.numpy() for p in
            tree_flatten(tr.gathered(tr.params, tr.p_specs))[0][:3]]
    pod = Mesh({"pod": 2, "data": 2, "model": 1},
               init_device_mesh("cpu", (2, 2, 1),
                                mesh_dim_names=("pod", "data", "model")),
               torch.device("cpu"))
    tr = trainer(6, pod)
    tr.init_state()
    out["pod"] = _records([tr.train_step() for _ in range(3)])
    out["pod_rows"] = (tr.tok_spec, tr._first_row, tr.rows_per_rank)
    tr = trainer(DP_BATCH, make_debug_mesh(2, 2, device="cpu"))
    tr.init_state()
    out["tp"] = _records([tr.train_step() for _ in range(3)])
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


# ----------------------------------------------------- tensor parallelism
# (name, arch, config overrides) of tests/test_torch_tp.py: every family's
# reduced config, plus two whose dims split over (2, 2) but not over
# (1, 4), each then taking its whole-weight path: a dense one with 3
# heads ("seq" attention at both), vocab 510 and d_ff 126, and a hybrid
# one with 3 experts and 2 SSD heads in one group; and two at sequence
# lengths (TP_SEQ) that do not split over "model" = 4: dense at 30 (whole
# on every rank at (1, 4), split at (2, 2)), the 3-head dense one at 30
# (at (1, 4) the head then whole and every position on every rank) and
# encdec at 68, whose encoder's 17 frames split over neither mesh while
# its decoder's do
TP_CASES = (("dense", "smollm_360m", {}),
            ("dense_s30", "smollm_360m", {}),
            ("dense_seq", "smollm_360m", {"n_heads": 3, "n_kv": 1,
                                          "vocab": 510, "d_ff": 126}),
            ("dense_seq_s30", "smollm_360m", {"n_heads": 3, "n_kv": 1,
                                              "vocab": 510, "d_ff": 126}),
            ("moe", "phi3_5_moe_42b", {}),
            ("ssm", "mamba2_370m", {}),
            ("hybrid", "jamba_1_5_large_398b", {}),
            ("hybrid_odd", "jamba_1_5_large_398b",
             {"n_experts": 3, "ssm_headdim": 64, "ssm_ngroups": 1}),
            ("encdec", "seamless_m4t_large_v2", {}),
            ("encdec_e17", "seamless_m4t_large_v2", {}))
TP_SEQ = {"dense_s30": 30, "dense_seq_s30": 30, "encdec_e17": 68}
TP_MESHES = ((2, 2), (1, 4))
TP_BATCH, TP_STEPS = 2, 3
# the case whose codec and int8 moments are held to one device's bits (its
# w_down, wo and lm_head rows split over the data axes or "model")
TP_CODEC = ("dense",)
COLLECTIVE_SHAPE = (4, 8, 6)        # (ranks, rows, cols)


def tp_config(case):
    import dataclasses
    from repro_torch.configs import get_config
    _, arch, kw = next(c for c in TP_CASES if c[0] == case)
    return dataclasses.replace(get_config(arch).reduced(), **kw)


def tp_seq(case) -> int:
    return TP_SEQ.get(case, SEQ)


def tp_trainer(case, mesh=None, device="cpu", **kw):
    import torch
    from repro_torch.launch.train import Trainer
    return Trainer(tp_config(case), batch=TP_BATCH, seq_len=tp_seq(case),
                   mesh=mesh, compute_dtype=torch.float32, device=device,
                   **kw)


def stored_bytes(tr) -> int:
    """Bytes this rank keeps for a step: its state's shards and its rows
    of the step's tokens (and encoder frames)."""
    from repro_torch.models.model import tree_flatten
    tokens, enc = tr.batch_inputs(tr.step)
    rows = [t[tr._first_row:tr._first_row + tr.rows_per_rank]
            for t in (tokens, enc) if t is not None]
    return sum(t.numel() * t.element_size() for t in
               tree_flatten(tr.state_tree())[0] + rows)


def load_tree(path):
    """A nested dict of numpy arrays from an npz of '/'-joined keys."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            d = out
            *head, last = key.split("/")
            for k in head:
                d = d.setdefault(k, {})
            d[last] = z[key]
    return out


def collective_inputs():
    rng = np.random.default_rng(5)
    x = rng.normal(size=COLLECTIVE_SHAPE).astype(np.float32)
    g = rng.normal(size=COLLECTIVE_SHAPE).astype(np.float32)
    return x, g


def _collectives(rank, group):
    """Each collective's output and input gradient on this rank."""
    import torch
    from repro_torch.distributed import collectives as C
    x, g = (torch.from_numpy(a[rank]) for a in collective_inputs())
    out = {}
    for name, fn, seed in (
            ("all_gather", lambda t: C.all_gather(t, 1, group),
             lambda y: torch.cat([g] * 4, 1)),
            ("reduce_scatter", lambda t: C.reduce_scatter(t, 0, group),
             lambda y: g[:2]),
            ("copy_to_group", lambda t: C.copy_to_group(t, group),
             lambda y: g),
            ("reduce_from_group", lambda t: C.reduce_from_group(t, group),
             lambda y: g)):
        t = x.clone().requires_grad_(True)
        y = fn(t)
        y.backward(seed(y))
        out[name] = (y.detach().numpy(), t.grad.numpy())
    out["all_reduce_max"] = C.all_reduce_max(x.clone(), group).numpy()
    return out


def tp_ranks(rank, world, tmp, cases, extras):
    """The tensor-parallel scenario: each of ``cases`` on the (2, 2) and
    (1, 4) meshes (step 0's loss and gathered gradients, three steps, the
    stored shapes); with ``extras`` also collectives over the (1, 4)
    mesh's "model" group, shard/gather round trips, the codec and int8
    moments on (2, 2), and a (2, 2) checkpoint restored by (1, 4) and
    (4, 1)."""
    import torch
    from repro_torch.distributed.compression import compress_tree
    from repro_torch.distributed.sharding import P, gather_tensor, \
        shard_tensor
    from repro_torch.launch.cluster import initialize_from_env
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.model import tree_flatten

    initialize_from_env(device="cpu", timeout_s=COLLECTIVE_TIMEOUT_S)
    meshes = {s: make_debug_mesh(*s, device="cpu") for s in TP_MESHES}
    m22 = meshes[2, 2]
    out = {}
    for case in cases:
        cfg = tp_config(case)
        tree = load_tree(f"{tmp}/{case}.npz")
        for shape, mesh in meshes.items():
            tr = tp_trainer(case, mesh)
            tr.init_state(params=params_from_reference(tree, cfg))
            mine = params_from_reference(tree, cfg, mesh=mesh)
            out[case, shape, "convert"] = all(
                torch.equal(a, b) for a, b in zip(
                    tree_flatten(mine)[0], tree_flatten(tr.params)[0]))
            loss, grads = tr.loss_and_grads()
            out[case, shape, "step0"] = (
                float(loss), [a.numpy() for a in tree_flatten(
                    tr.gathered(grads, tr.p_specs))[0]])
            recs = [tr.apply_grads(loss, grads)]
            recs += [tr.train_step() for _ in range(TP_STEPS - 1)]
            out[case, shape] = _records(recs)
            out[case, shape, "bytes"] = recs[-1]["collective_bytes"]
            out[case, shape, "stored"] = stored_bytes(tr)
            out[case, shape, "shapes"] = [
                tuple(t.shape) for t in tree_flatten(tr.state_tree())[0]]

    if not extras:
        return out
    out["collectives"] = _collectives(rank, meshes[1, 4].group("model"))
    g = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    out["round_trip"] = [
        torch.equal(gather_tensor(shard_tensor(g, s, m22), s, m22), g)
        for s in (P("data", "model"), P("model", None), P(None, "data"),
                  P(("data", "model"), None), P(None, None))]
    out["split"] = {case: (tr.par.split, tr.par.split_enc) for case, tr in
                    ((c, tp_trainer(c, meshes[1, 4])) for c in
                     ("dense", "dense_s30", "dense_seq_s30",
                      "encdec_e17"))}
    for case in TP_CODEC:
        tr = tp_trainer(case, m22, compress_grads=True, opt_state="int8")
        tr.init_state(params=params_from_reference(
            load_tree(f"{tmp}/{case}.npz"), tp_config(case)))
        tr.train_step()
        state = tr.state_tree()
        _, grads = tr.loss_and_grads()
        deq, res = compress_tree(grads, tr.residuals, tr.row_groups)
        params, opt = tr.opt.update(deq, tr.opt_state, tr.params,
                                    tr.row_groups)
        whole = {n: tree_flatten(tr.gathered(t, s))[0] for n, t, s in (
            ("grads", grads, tr.p_specs), ("deq", deq, tr.p_specs),
            ("res", res, tr.p_specs), ("params", params, tr.p_specs),
            ("opt", opt, tr.o_specs))}
        whole["before"] = tree_flatten(tr.gathered(state,
                                                   tr.state_specs()))[0]
        out[case, "codec"] = {k: [a.numpy() for a in v]
                              for k, v in whole.items()}

    tr = tp_trainer("dense", m22)
    tr.init_state(params=params_from_reference(load_tree(f"{tmp}/dense.npz"),
                                               tp_config("dense")))
    for _ in range(2):
        tr.train_step()
    tr.save(f"{tmp}/ck")
    out["uninterrupted"] = _records([tr.train_step()])
    restored = {}
    for shape in ((1, 4), (4, 1)):
        t2 = tp_trainer("dense", meshes.get(shape) or make_debug_mesh(
            *shape, device="cpu"))
        restored[shape] = (t2.restore(f"{tmp}/ck"),
                           _records([t2.train_step()]))
    out["restored"] = restored
    return out
