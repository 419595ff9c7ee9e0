"""Data-parallel training over ``torch.distributed`` on the CPU (gloo),
held against the one-device trainer and the reference.

* Four spawned ranks (``tests/torch_ranks.py``, one spawn for every case
  that shares that world) join through the REPRO_* variables, build a
  (4, 1) mesh and run ``compressed_psum`` (against the reference's under
  ``jax.vmap(axis_name="data")`` over the same 4 slices: bit for bit) and
  the data-parallel trainer in f32 compute, plain, with compressed
  gradients and with int8 moments, against ``Trainer(mesh=None)`` at the
  same global batch: step 0 to rel 1e-5, later steps to rel 1e-3, the
  bounds of ``tests/test_elastic.py:32-37`` (the replicas' mean is the
  full batch's mean summed in another order, and Adam amplifies that).
* Two spawned ranks restore the four replicas' checkpoint with
  ``plan_elastic_restart``'s accumulation: the losses continue the
  uninterrupted run to rtol 1e-4 (``tests/test_elastic.py:61``); then the
  launcher joins a group itself (REPRO_MULTIHOST=1).
* One gloo rank in this process: bit for bit ``Trainer(mesh=None)``.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_ranks as ranks  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    plan_elastic_restart)
from repro_torch.launch import cluster  # noqa: E402
from repro_torch.launch.mesh import (make_debug_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.model import tree_flatten  # noqa: E402

STEP0_REL, LATER_REL, ELASTIC_RTOL = 1e-5, 1e-3, 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced trainers here run on one intra-op thread, as each
    spawned rank does: their ops are too small to gain from more, and
    spare threads only contend with the other test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp4")
    return tmp, ranks.run_ranks(ranks.four_ranks, 4, str(tmp / "store"),
                                str(tmp))


@pytest.fixture(scope="module")
def two(four):
    tmp = four[0]
    plan = plan_elastic_restart(alive=[0, 1], total_hosts=4, dp_size=4,
                                global_batch=ranks.DP_BATCH)
    assert (plan.dp_size, plan.accum_steps, plan.global_batch) == (2, 2, 8)
    return ranks.run_ranks(ranks.two_ranks, 2, str(tmp / "store2"),
                           str(tmp), plan.accum_steps)


@pytest.fixture(scope="module")
def one_device():
    """``Trainer(mesh=None)`` records at the same global batches."""
    out = {}
    for name, kw, steps in ranks.DP_CASES + (("pod", {}, 3),):
        tr = ranks.trainer(6 if name == "pod" else ranks.DP_BATCH, **kw)
        tr.init_state()
        out[name] = [(r["loss"], r["grad_norm"])
                     for r in (tr.train_step() for _ in range(steps))]
    return out


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after."""
    cluster.initialize_from_env(f"file://{tmp_path}/store", 1, 0,
                                device="cpu", timeout_s=60)
    try:
        yield make_debug_mesh(1, 1, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


def _close(got, want, rel):
    assert got == pytest.approx(want, rel=rel), (got, want)


def test_repro_variables_bring_up_four_gloo_ranks(four):
    res = four[1]
    for rank, r in enumerate(res):
        assert r["info"] == {"process_index": rank, "process_count": 4,
                             "local_devices": 1, "global_devices": 4}
        assert r["backend"] == "gloo" and r["coord"] == rank
        assert r["shape"] == {"data": 4, "model": 1}
        assert (r["data_group"], r["model_group"]) == (4, 1)


def test_compressed_psum_over_four_ranks_matches_reference(four):
    g, r = ranks.psum_inputs()
    ref_out, ref_res = jax.vmap(
        lambda a, b: ref_comp.compressed_psum(a, b, "data"),
        axis_name="data")(g, r)
    plain_out, plain_res = comp.compressed_psum_reference(
        list(torch.from_numpy(g)), list(torch.from_numpy(r)))
    for rank, res in enumerate(four[1]):
        out, new_res = res["psum"]
        np.testing.assert_array_equal(out, np.asarray(ref_out[rank]))
        np.testing.assert_array_equal(new_res, np.asarray(ref_res[rank]))
        np.testing.assert_array_equal(out, plain_out.numpy())
        np.testing.assert_array_equal(new_res, plain_res[rank].numpy())


@pytest.mark.parametrize("case", [c[0] for c in ranks.DP_CASES])
def test_dp_trainer_matches_one_device(four, one_device, case):
    res = four[1]
    want = one_device[case]
    got = res[0][case]
    assert len(got) == len(want)
    for k in (0, 1):
        _close(got[0][k], want[0][k], STEP0_REL)
        for a, b in zip(got[1:], want[1:]):
            _close(a[k], b[k], LATER_REL)
    # the replicas agree bit for bit, and each took its own rows
    for rank, r in enumerate(res):
        assert r[case] == got
        for a, b in zip(r[case + "_params"], res[0][case + "_params"]):
            np.testing.assert_array_equal(a, b)
        assert r[case + "_rows"] == (2 * rank, 2)
        comm = r[case + "_comm"]
        assert comm["replicas"] == 4
        assert comm["grad_bytes"] <= comm["all_reduce_bytes"] - 4 < \
            comm["grad_bytes"] + 512 * 64


def test_pod_mesh_falls_back_to_the_inner_axis(four, one_device):
    """Batch 6 on a (2, 2, 1) pod mesh: 6 rows do not split four ways, so
    ``data_spec`` splits them over "data" and each pod holds a copy."""
    res = four[1]
    for rank, r in enumerate(res):
        spec, first, rows = r["pod_rows"]
        assert tuple(spec) == ("data", None)
        assert (first, rows) == (3 * (rank % 2), 3)
        assert r["pod"] == res[0]["pod"]
    got, want = res[0]["pod"], one_device["pod"]
    for k in (0, 1):
        _close(got[0][k], want[0][k], STEP0_REL)
        for a, b in zip(got[1:], want[1:]):
            _close(a[k], b[k], LATER_REL)


def test_run_loop_on_four_ranks(four):
    """One log (rank 0 writes it), a heartbeat per rank, the checkpoint."""
    tmp, res = four
    lines = (tmp / "log.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2]
    assert sorted(os.listdir(tmp / "hb")) == [f"host_{r:05d}.hb"
                                              for r in range(4)]
    assert sorted(os.listdir(tmp / "ck")) == ["LATEST", "step_00000002"]


def test_model_axis_of_two_matches_one_device(four, one_device):
    """A (2, 2) mesh: two replicas, each tensor parallel over two ranks,
    trains the one-device trajectory, and every rank reports it."""
    res = four[1]
    got, want = res[0]["tp"], one_device["f32"][:3]
    for k in (0, 1):
        _close(got[0][k], want[0][k], STEP0_REL)
        for a, b in zip(got[1:], want[1:]):
            _close(a[k], b[k], LATER_REL)
    assert all(r["tp"] == got for r in res)


def test_elastic_restore_four_to_two_replicas(four, two):
    """4 replicas, checkpoint at step 2; 2 replicas with accum 2 restore it
    and continue the uninterrupted run's losses."""
    want = [loss for loss, _ in four[1][0]["f32"][2:4]]
    for rank, r in enumerate(two):
        assert r["step"] == 2
        assert r["rows"] == (4 * rank, 4)
        np.testing.assert_allclose([loss for loss, _ in r["restored"]], want,
                                   rtol=ELASTIC_RTOL)


def test_launcher_joins_from_repro_multihost(four, two):
    """``main()`` under REPRO_MULTIHOST=1: a debug mesh of the world size,
    two replicas, one log, a heartbeat each, the group torn down."""
    tmp = four[0]
    for r in two:
        assert [x["step"] for x in r["cli"]] == [1, 2]
        assert all(x["replicas"] == 2 and np.isfinite(x["loss"])
                   for x in r["cli"])
        assert [(x["loss"], x["grad_norm"]) for x in r["cli"]] == \
            [(x["loss"], x["grad_norm"]) for x in two[0]["cli"]]
        assert not r["cli_after"]
    assert len((tmp / "cli.jsonl").read_text().splitlines()) == 2
    assert sorted(os.listdir(tmp / "cli_hb")) == ["host_00000.hb",
                                                  "host_00001.hb"]


@pytest.mark.parametrize("kw", [{}, {"compress_grads": True},
                                {"opt_state": "int8"}, {"accum_steps": 2}],
                         ids=["f32", "compress", "int8", "accum2"])
def test_one_gloo_rank_is_bit_identical_to_no_mesh(one_rank, kw):
    a = ranks.trainer(4, **kw)
    b = ranks.trainer(4, one_rank, **kw)
    a.init_state()
    b.init_state()
    ra = [a.train_step() for _ in range(3)]
    rb = [b.train_step() for _ in range(3)]
    assert [(r["loss"], r["grad_norm"]) for r in ra] == \
        [(r["loss"], r["grad_norm"]) for r in rb]
    for x, y in zip(tree_flatten(a.state_tree())[0],
                    tree_flatten(b.state_tree())[0]):
        assert torch.equal(x, y)
    assert rb[-1]["replicas"] == 1 and rb[-1]["all_reduce_ms"] >= 0


def test_one_rank_psum_and_refusals(one_rank):
    """``compressed_psum`` on one rank equals its plain version; a card
    mesh refuses a gloo group; a second mesh shape refuses the world."""
    g, r = torch.randn(8, 16), torch.randn(8, 16) * 0.01
    with pytest.raises(ValueError, match="unbound"):
        comp.compressed_psum(g, r, "data")
    with one_rank:
        out, res = comp.compressed_psum(g, r, "data")
    want, want_res = comp.compressed_psum_reference([g], [r])
    assert torch.equal(out, want) and torch.equal(res, want_res[0])
    with pytest.raises(ValueError, match="nccl"):
        make_debug_mesh(1, 1, device="cuda")
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_debug_mesh(2, 1, device="cpu")
    assert cluster.host_info()["process_count"] == 1


def test_meshes_without_a_process_group(monkeypatch):
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="512"):
        make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(RuntimeError, match="initialize_from_env"):
        make_debug_mesh(1, 1, device="cpu")
    for k in ("REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
              "REPRO_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="REPRO_COORDINATOR"):
        cluster.initialize_from_env(device="cpu")
    assert cluster.init_method("host0:29500") == "tcp://host0:29500"
    assert cluster.init_method("file:///tmp/s") == "file:///tmp/s"
    monkeypatch.setenv("REPRO_MULTIHOST", "1")
    assert cluster.multihost_requested()
    assert cluster.host_info() == {"process_index": 0, "process_count": 1,
                                   "local_devices": 1, "global_devices": 1}
