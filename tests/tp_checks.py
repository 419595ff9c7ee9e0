"""Shared pieces of the tensor-parallel tests (``tests/test_torch_tp.py``,
``tests/test_torch_tp_families.py``): seeded numpy weights, the world
each file spawns once (``torch_ranks.tp_ranks`` in four gloo ranks while
this process computes the reference's ``jax.value_and_grad`` and the
mesh-less trainer on the same batches), and the per-(case, mesh) checks.

Tolerances: step 0's loss and each gathered gradient leaf within rel 1e-5
(of its largest |entry|) of ``Trainer(mesh=None)`` and the reference (of
the mesh-less trainer alone for ``hybrid_odd``, whose model code is
``hybrid``'s); steps 1–2 within rel 1e-3, the bounds of
``tests/test_elastic.py:32-37`` (the same f32 sums in another order,
which Adam amplifies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks as ranks
from repro import configs as ref_configs
from repro.models.model import Model as RefModel
from repro_torch.distributed.sharding import local_shape, tree_shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import make_params, tree_flatten

STEP0_REL, LATER_REL = 1e-5, 1e-3
# the trainers' SSD chunk is the sequence (32); the reference's gradient at
# that chunk is NaN on the hybrid (exp overflows above its chunk's
# diagonal before the mask; ROADMAP Queue C), so there it runs chunks of
# 8, the same scan summed in another order, and its gradients are held to
# the reference-parity bound of tests/test_torch_train.py (1e-4 of each
# leaf's largest |entry|; the mesh-less port is 8.6e-6 from it)
REF_SSD_CHUNK = {"hybrid": 8}
REF_GRAD_REL = {"hybrid": 1e-4}
# the reference's value_and_grad for every case but hybrid_odd
REF_CASES = [c[0] for c in ranks.TP_CASES if c[0] != "hybrid_odd"]
MESHES = ranks.TP_MESHES


def mesh_id(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def one_thread():
    """A module fixture's body: the reduced trainers here run on one
    intra-op thread, as each spawned rank does."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _NumpyMaker:
    """Weights from a seeded numpy generator under the init rules of the
    param factories (``models/layers.py``), through the port's
    ``make_params``, whose tree is the reference's leaf for leaf."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def __call__(self, shape, logical, init="fan_in"):
        if init in ("zeros", "ones"):
            return np.full(shape, float(init == "ones"), np.float32)
        scale = 1.0 if init == "embed" else \
            float(np.prod(shape[:-1]) if len(shape) > 1 else shape[0]) ** -.5
        return (self.rng.normal(size=shape) * scale).astype(np.float32)


def _ref_params(case):
    """The reference model for ``case`` and its weights as numpy, the
    mamba constants drawn at a larger scale (else the SSD path is
    inert)."""
    _, arch, kw = next(c for c in ranks.TP_CASES if c[0] == case)
    cfg = dataclasses.replace(ref_configs.get_config(arch).reduced(), **kw)
    seq = ranks.tp_seq(case)
    model = RefModel(cfg, compute_dtype=jnp.float32, q_chunk=seq,
                     ssd_chunk=REF_SSD_CHUNK.get(case, seq), loss_chunk=seq,
                     remat=False)
    npp = make_params(ranks.tp_config(case), _NumpyMaker(0))
    rng = np.random.default_rng(1)

    def fix(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                fix(v)
            elif k in ("conv_x", "A_log", "dt_bias"):
                tree[k] = rng.normal(0, 0.5, v.shape).astype(np.float32)
    fix(npp)
    return model, npp


def _flat_keys(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_keys(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def world(tmp_path_factory, cases, extras):
    """One 4-rank spawn of ``torch_ranks.tp_ranks`` over ``cases`` (and
    ``extras``) while this process computes, per case, the reference's
    step-0 loss and gradients and the mesh-less trainer's step 0 and
    records: (tmp, the ranks' results, this process's)."""
    tmp = tmp_path_factory.mktemp("tp")
    models, here = {}, {}
    for case in cases:
        models[case], npp = _ref_params(case)
        np.savez(tmp / f"{case}.npz", **dict(_flat_keys(npp)))
        here[case] = {"npp": npp}

    def during():
        for case in cases:
            cfg = ranks.tp_config(case)
            tr = ranks.tp_trainer(case)
            tr.init_state(params=params_from_reference(here[case]["npp"],
                                                       cfg))
            if case in REF_CASES:
                tokens, enc = tr.batch_inputs(0)
                args = (jnp.asarray(tokens.numpy()),) + (
                    () if enc is None else (jnp.asarray(enc.numpy()),))
                loss, grads = jax.jit(jax.value_and_grad(
                    models[case].loss_fn))(
                    jax.tree.map(jnp.asarray, here[case]["npp"]), *args)
                here[case]["ref"] = (float(loss), [np.asarray(g) for g in
                                                   jax.tree.leaves(grads)])
            l0, g0 = tr.loss_and_grads()
            here[case]["none"] = (float(l0), [g.numpy() for g in
                                              tree_flatten(g0)[0]])
            recs = [tr.apply_grads(l0, g0)]
            here[case]["records"] = ranks._records(
                recs + [tr.train_step() for _ in range(ranks.TP_STEPS - 1)])

    res = ranks.run_ranks(ranks.tp_ranks, 4, str(tmp / "store"), str(tmp),
                          list(cases), extras, during=during)
    return tmp, res, here


def _close_grads(got, want, rel):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= rel * scale, (
            i, float(np.abs(g - w).max()), scale)



def step0(world, case, mesh):
    """Every rank's loss and the gathered global gradient against
    ``Trainer(mesh=None)`` and the reference's ``value_and_grad``."""
    here = world[2][case]
    for res in world[1]:
        loss, grads = res[case, mesh, "step0"]
        wants = [(here["none"], STEP0_REL)]
        if case in REF_CASES:
            wants.append((here["ref"], REF_GRAD_REL.get(case, STEP0_REL)))
        for (want_loss, want_grads), rel in wants:
            assert loss == pytest.approx(want_loss, rel=STEP0_REL)
            _close_grads(grads, want_grads, rel)


def steps(world, case, mesh):
    """Three steps' (loss, grad norm) against the mesh-less trainer's, the
    same on every rank."""
    want = world[2][case]["records"]
    got = world[1][0][case, mesh]
    for k in (0, 1):
        assert got[0][k] == pytest.approx(want[0][k], rel=STEP0_REL)
        for a, b in zip(got[1:], want[1:]):
            assert a[k] == pytest.approx(b[k], rel=LATER_REL)
    assert all(r[case, mesh] == got for r in world[1])


def shards(world, case, mesh):
    """The stored state's shapes are ``local_shape`` of the plan (f32
    moments and the step, params, 0-d residuals), and the converter's
    shards are the trainer's; a "model" axis moves bytes both ways."""
    tr = ranks.tp_trainer(case)
    abstract = Mesh.abstract(mesh, ("data", "model"))
    shapes = tr.model.param_shapes()
    logical = tr.model.param_logical_specs()
    want = []
    plans = (tree_shardings(shapes, logical, abstract),
             tree_shardings(tr.opt.init(shapes),
                            tr.opt.state_logical_specs(logical), abstract))
    for tree, plan in zip((shapes, tr.opt.init(shapes)), plans):
        want.append([local_shape(t.shape, s.spec, abstract) for t, s in
                     zip(tree_flatten(tree)[0], tree_flatten(plan)[0])])
    # the state tree's keys in order: opt, params, residuals (0-d)
    want = want[1] + want[0] + [()] * len(want[0])
    for res in world[1]:
        assert res[case, mesh, "shapes"] == want
        assert res[case, mesh, "convert"]
    if mesh[1] > 1:
        moved = world[1][0][case, mesh, "bytes"]
        assert moved["all_gather"] > 0 and moved["reduce_scatter"] > 0
