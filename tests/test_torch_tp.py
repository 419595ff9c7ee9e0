"""Tensor parallelism over the "model" axis and FSDP storage of "embed" in
the port's ``Trainer(mesh=)``, on the CPU over gloo, held against
``Trainer(mesh=None)`` and the reference (``tests/tp_checks.py``).

* One spawn of four ranks (``tests/torch_ranks.py``: one intra-op thread,
  a file-store rendezvous, collective and join timeouts) builds a (2, 2)
  and a (1, 4) mesh in one world and runs ``torch_ranks.tp_ranks``: the
  dense, moe and encdec families' reduced configs in f32 (dense 4 heads /
  2 kv: "heads" attention, the kv gathered at m = 4; dense 3 heads / 1
  kv, vocab 510, d_ff 126: "seq" attention, and at m = 4 the head and
  the MLP whole; both dense configs at S = 30 and encdec at S = 68 (17
  encoder frames), whose lengths do not split four ways: the residual
  stream whole on each rank, and at (1, 4) the 3-head one's head whole
  with every position on every rank), the collectives' forward and
  backward, shard/gather round trips, the codec and int8 moments, and a (2, 2) checkpoint
  restored on (1, 4) and (4, 1).  ``tests/test_torch_tp_families.py``
  does the same for the ssm and hybrid families.
* Tolerances as ``tests/tp_checks.py`` states; a restored run continues
  the losses to rtol 1e-4 (``tests/test_elastic.py:61``); the codec and
  int8 moments on shards are bit for bit the one-device codec on the
  gathered tensors.
* No processes: shard/gather shapes for every leaf of the ten configs on
  abstract (16, 16) and (2, 16, 16) meshes, ``launch/dryrun.py``'s
  ``_accum_steps`` / ``_analytic_memory`` against the reference's, and
  the dry run's trace of the dense cases on a fake world of four
  (``launch/cost_analysis.py``) against the live ranks' collective and
  stored bytes.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import tp_checks as checks  # noqa: E402
import torch_ranks as ranks  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed.compression import compress_tree  # noqa: E402
from repro_torch.distributed.optimizer import Adam, AdamConfig  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    gather_tensor, local_shape, shard_tensor, tree_shardings)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.model import tree_flatten, tree_unflatten  # noqa: E402

RESTORE_RTOL = 1e-4
# the dense, moe and encdec cases and every mesh-wide check; the ssm and
# hybrid families spawn their own world in tests/test_torch_tp_families.py,
# so that each file's share of an xdist worker stays small
CASES = ("dense", "dense_seq", "dense_s30", "dense_seq_s30", "moe", "encdec",
         "encdec_e17")
ABSTRACT = {"16x16": ((16, 16), ("data", "model")),
            "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


one_thread = pytest.fixture(scope="module", autouse=True)(checks.one_thread)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return checks.world(tmp_path_factory, CASES, extras=True)


# ------------------------------------------------------------ collectives
def test_collectives_match_single_process(world):
    x, g = ranks.collective_inputs()
    n = x.shape[0]
    total_x, total_g = x.sum(0), g.sum(0)
    for r, res in enumerate(world[1]):
        got = res["collectives"]
        want = {
            "all_gather": (np.concatenate(list(x), 1), total_g),
            "reduce_scatter": (np.split(total_x, n, 0)[r],
                               np.concatenate([gi[:2] for gi in g], 0)),
            "copy_to_group": (x[r], total_g),
            "reduce_from_group": (total_x, g[r]),
        }
        for name, (y, gx) in want.items():
            np.testing.assert_allclose(got[name][0], y, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got[name][1], gx, rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(got["all_reduce_max"], x.max(0))


def test_shard_gather_round_trips_on_a_live_mesh(world):
    for res in world[1]:
        assert res["round_trip"] == [True] * 5


@pytest.mark.parametrize("mesh_name", sorted(ABSTRACT))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shard_gather_shapes_on_abstract_meshes(arch, mesh_name):
    """Every param and Adam leaf (f32 and int8) at full size: the shard
    has ``local_shape``, and gathering it gives the global shape back."""
    shape, names = ABSTRACT[mesh_name]
    mesh = Mesh.abstract(shape, names)
    model = Model(configs.get_config(arch), device="cpu")
    logical = model.param_logical_specs()
    p_shapes = model.param_shapes()
    trees = [(p_shapes, logical)]
    for dt in ("f32", "int8"):
        opt = Adam(AdamConfig(state_dtype=dt))
        trees.append((opt.init(p_shapes), opt.state_logical_specs(logical)))
    coords = {a: n - 1 for a, n in zip(names, shape)}
    for tree, log in trees:
        plan = tree_shardings(tree, log, mesh)
        for t, s in zip(tree_flatten(tree)[0], tree_flatten(plan)[0]):
            local = shard_tensor(t, s.spec, mesh, coords)
            assert tuple(local.shape) == local_shape(t.shape, s.spec, mesh)
            assert gather_tensor(local, s.spec, mesh).shape == t.shape


# --------------------------------------------------------------- training
@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_step0_loss_and_gradients(world, case, mesh):
    checks.step0(world, case, mesh)


@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_steps_match_one_device(world, case, mesh):
    checks.steps(world, case, mesh)


@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", CASES)
def test_each_rank_stores_its_shards(world, case, mesh):
    checks.shards(world, case, mesh)


@pytest.mark.parametrize("case", ranks.TP_CODEC)
def test_codec_and_int8_moments_bit_for_bit(world, case):
    """On (2, 2): the compressed gradient, its residual and the int8 Adam
    update of the shards, gathered, equal the one-device codec and Adam
    on the gathered tensors."""
    got = world[1][0][case, "codec"]
    t = {k: [torch.from_numpy(a) for a in v] for k, v in got.items()}
    tr = ranks.tp_trainer(case, compress_grads=True, opt_state="int8")
    tr.init_state()
    _, treedef = tree_flatten(tr.params)
    n = len(t["grads"])
    before = tree_unflatten(tree_flatten(tr.state_tree())[1],
                            t["before"])
    deq, res = compress_tree(tree_unflatten(treedef, t["grads"]),
                             before["residuals"])
    for a, b in zip(tree_flatten(deq)[0] + tree_flatten(res)[0],
                    t["deq"] + t["res"]):
        assert torch.equal(a, b)
    params, opt = tr.opt.update(deq, before["opt"], before["params"])
    want = tree_flatten(params)[0] + tree_flatten(opt)[0]
    assert len(want) == n + len(t["opt"])
    for a, b in zip(want, t["params"] + t["opt"]):
        assert torch.equal(a, b)


def test_checkpoint_crosses_meshes_and_packages(world):
    """A (2, 2) checkpoint at step 2: (1, 4), (4, 1) and ``mesh=None``
    restore it and continue the uninterrupted run's loss; the reference's
    ``checkpoint.restore`` reads the same global arrays."""
    tmp, res, _ = world
    want = res[0]["uninterrupted"][0][0]
    for r in res:
        for shape, (step, recs) in r["restored"].items():
            assert step == 2, shape
            np.testing.assert_allclose(recs[0][0], want, rtol=RESTORE_RTOL)
    tr = ranks.tp_trainer("dense")
    assert tr.restore(str(tmp / "ck")) == 2
    leaves = [t.numpy() for t in tree_flatten(tr.state_tree())[0]]
    np.testing.assert_allclose(tr.train_step()["loss"], want,
                               rtol=RESTORE_RTOL)
    target = tree_unflatten(tree_flatten(tr.state_tree())[1],
                            [np.zeros_like(a) for a in leaves])
    got, step = ref_ckpt.restore(str(tmp / "ck"), target)
    assert step == 2
    for a, b in zip(jax.tree.leaves(got), leaves):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_sequence_must_split_over_the_model_axis(world):
    """Only to run sequence parallel: at (1, 4) a length of 30 (or an
    encoder's 17 frames) trains with the residual whole on each rank,
    the decoder's 68 split (the cases' steps above)."""
    assert world[1][0]["split"] == {"dense": (True, True),
                                    "dense_s30": (False, False),
                                    "dense_seq_s30": (False, False),
                                    "encdec_e17": (True, False)}


@pytest.mark.parametrize("mesh", checks.MESHES, ids=checks.mesh_id)
@pytest.mark.parametrize("case", ("dense", "dense_s30"))
def test_dry_run_counts_equal_the_live_step(world, case, mesh):
    """The dry run's trace of rank 0's step on a fake world of four: its
    collective bytes by kind and its argument bytes equal what the live
    rank 0 counted and stored."""
    from repro_torch.launch.cost_analysis import fake_world, trace_step
    from repro_torch.launch.mesh import make_debug_mesh
    live = world[1][0]
    with fake_world(4):
        tr = ranks.tp_trainer(case, make_debug_mesh(*mesh, device="meta"),
                              device="meta")
        got = trace_step(tr)
    assert dict(got.cost.collectives.per_op) == {
        k: v for k, v in live[case, mesh, "bytes"].items() if v}
    assert got.memory["argument_size_in_bytes"] == live[case, mesh,
                                                         "stored"]


# ----------------------------------------------------------------- dryrun
@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dryrun module: it sets XLA_FLAGS when imported, so
    the JAX backend is started first and the flag put back."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if old is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = old
    return mod


@pytest.mark.parametrize("mesh_name", sorted(ABSTRACT))
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_accum_steps_and_analytic_memory_match_reference(ref_dryrun, arch,
                                                         mesh_name):
    mesh = Mesh.abstract(*ABSTRACT[mesh_name])
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for name, shape in configs.SHAPES.items():
        ref_shape = ref_configs.SHAPES[name]
        accum = dryrun._accum_steps(cfg, shape, mesh)
        assert accum == ref_dryrun._accum_steps(ref_cfg, ref_shape, mesh)
        for dt in ("f32", "int8"):
            assert dryrun._analytic_memory(cfg, shape, mesh, accum, dt) == \
                ref_dryrun._analytic_memory(ref_cfg, ref_shape, mesh, accum,
                                            dt)
