"""The frozen generators and the plain reference against the program on
the CPU, where the cuda backend runs its kernels' plain versions."""
import copy

import numpy as np
import pytest
import torch

from repro_torch import core
from repro_torch.data import datasets as program_datasets
from repro_torch.kernels import ops as kops
from repro_torch.trees.random_forest import RandomForest, RandomForestConfig

from chipbench import datasets, models, program, reference, trainer
from chipbench.models import random_forest, random_trees

FIELDS = ("feature", "threshold", "left", "right", "leaf_lo", "leaf_mid",
          "leaf_hi", "leaf_value", "n_nodes")


def _same_ir(model, forest):
    for f in FIELDS:
        np.testing.assert_array_equal(model[f], getattr(forest, f), err_msg=f)
    np.testing.assert_array_equal(model["n_leaves"], forest.n_leaves_per_tree)
    assert int(model["max_depth"]) == forest.max_depth


def test_frozen_datasets_match_program():
    ours = datasets.load("msn").make_msn()
    theirs = program_datasets.make_msn()
    for a, b in zip(ours, (theirs.X_train, theirs.y_train, theirs.X_test,
                           theirs.y_test)):
        np.testing.assert_array_equal(a, b)
    ours = datasets.load("magic").make_magic()
    theirs = program_datasets.make_magic()
    for a, b in zip(ours[:4], (theirs.X_train, theirs.y_train, theirs.X_test,
                               theirs.y_test)):
        np.testing.assert_array_equal(a, b)


def test_magic_draws_keep_the_distribution():
    """Fresh magic rows come from make_magic's own means, order and scales:
    replaying its generator's draws gives its rows back."""
    magic = datasets.load("magic")
    rng = np.random.default_rng(101)
    means = rng.normal(0, magic.SEP, size=(magic.C, 2, magic.D_INFORMATIVE))
    X, y, perm = magic._rows(rng, 6000, means)
    scale = rng.uniform(0.5, 50.0, size=(1, magic.D))
    want = program_datasets.make_magic()
    _, perm0, scale0 = magic._distribution()
    np.testing.assert_array_equal(perm, perm0)
    np.testing.assert_array_equal(scale, scale0)
    idx = rng.permutation(6000)[1200:]
    np.testing.assert_array_equal((X * scale)[idx], want.X_train)
    rows, labels = magic.draw(64, np.random.default_rng(5))
    assert rows.dtype == np.float32 and rows.shape == (64, 10)
    assert set(np.unique(labels)) <= {0, 1}


def test_frozen_trainer_grows_the_programs_trees():
    X, y = datasets.load("magic").train_rows()
    roots, C = trainer.random_forest(X, y.astype(np.int64), n_trees=3,
                                     max_leaves=16, seed=4)
    rf = RandomForest(RandomForestConfig(n_trees=3, max_leaves=16,
                                         seed=4)).fit(X, y)
    _same_ir(models.canonical(roots, X.shape[1], C),
             core.from_random_forest(rf))


def test_random_trees_have_random_forest_irs_shape():
    cfg = {"n_trees": 5, "n_leaves": 64, "n_features": 136, "n_classes": 1,
           "seed": 3}
    model = random_trees.make(cfg)
    ir = core.random_forest_ir(5, 64, 136, seed=3, full=True)
    for f in ("left", "right", "leaf_lo", "leaf_mid", "leaf_hi", "n_nodes"):
        np.testing.assert_array_equal(model[f], getattr(ir, f), err_msg=f)
    assert int(model["max_depth"]) == ir.max_depth
    assert model["feature"].shape == ir.feature.shape
    assert model["leaf_value"].shape == ir.leaf_value.shape


def _msn_model(n_trees=12):
    return random_trees.make({"n_trees": n_trees, "n_leaves": 64,
                              "n_features": 136, "n_classes": 1, "seed": 11})


MSN_CFG = {"quant": {"bits": 16, "int_accum": True}, "engine": "bitvector",
           "backend": "cuda"}


def _magic_model():
    cfg = {"model": "random_forest", "dataset": "magic", "n_trees": 24,
           "max_leaves": 16, "n_bins": 64, "n_features": 10,
           "n_classes": 2, "seed": 0, "quant": {"bits": 16,
                                                "int_accum": True},
           "engine": "bitvector", "backend": "cuda",
           "cascade": {"stages": [4, 8, 24], "gate": "margin",
                       "thresholds": [0.5, 0.7, 0.9], "floor_pp": 0.5,
                       "calibration_rows": 2000, "calibration_seed": 8}}
    return random_forest.make(cfg), cfg


@pytest.mark.parametrize("rows", [1, 37, 300])
def test_reference_matches_port_bit_for_bit(rows):
    model = _msn_model()
    train, _ = datasets.load("msn").train_rows()
    pred, _ = program.build(model, MSN_CFG, train, "cpu")
    X, _ = datasets.load("msn").draw(rows, np.random.default_rng(rows))
    q = reference.quantize_model(model, train, 16)
    sums, compares = reference.traverse(q, q.rows(X))
    np.testing.assert_array_equal(pred.predict(X), q.descale(sums))
    assert (compares == 12 * 6).all()        # full trees: 6 compares each


def test_reference_cascade_matches_fused_port_exits_included():
    model, cfg = _magic_model()
    assert np.isfinite(model["gate_threshold"])
    train, _ = datasets.load("magic").train_rows()
    pred, _ = program.build(model, cfg, train, "cpu")
    X, _ = datasets.load("magic").draw(500, np.random.default_rng(9))
    q = reference.quantize_model(model, train, 16)
    stages = cfg["cascade"]["stages"]
    sums, exit_stage, _ = reference.cascade(
        q, q.rows(X), stages, float(model["gate_threshold"]))
    np.testing.assert_array_equal(pred.predict(X), q.descale(sums))
    np.testing.assert_array_equal(
        pred.last_exit_counts, np.bincount(exit_stage, minlength=3))
    assert 0 < (exit_stage < 2).sum() < len(X)        # the gate does work
    fn = kops.cuda_fused_cascade_qs(pred.forest, pred.stages, pred.policy,
                                    device="cpu")
    xq = torch.from_numpy(np.ascontiguousarray(
        pred.transform_inputs(X), dtype=np.float32))
    _, port_exits = fn(xq, torch.ones(len(X), dtype=torch.bool))
    np.testing.assert_array_equal(port_exits.numpy(), exit_stage)


def test_a_forest_quantized_to_fewer_bits_fails():
    """The control: the program's own int8 path against the int16
    reference, for the plain forest and the cascade."""
    train, _ = datasets.load("msn").train_rows()
    model = _msn_model()
    low = copy.deepcopy(MSN_CFG)
    low["quant"]["bits"] = 8
    pred, _ = program.build(model, low, train, "cpu")
    X, _ = datasets.load("msn").draw(200, np.random.default_rng(2))
    q = reference.quantize_model(model, train, 16)
    assert np.abs(pred.predict(X) - q.descale(
        reference.traverse(q, q.rows(X))[0])).max() > 0
    model, cfg = _magic_model()
    train, _ = datasets.load("magic").train_rows()
    low = copy.deepcopy(cfg)
    low["quant"]["bits"] = 8
    pred, _ = program.build(model, low, train, "cpu")
    X, _ = datasets.load("magic").draw(300, np.random.default_rng(3))
    q = reference.quantize_model(model, train, 16)
    sums, _, _ = reference.cascade(q, q.rows(X), cfg["cascade"]["stages"],
                                   float(model["gate_threshold"]))
    assert np.abs(pred.predict(X) - q.descale(sums)).max() > 0
