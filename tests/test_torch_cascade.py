"""The port's cascade (``repro_torch.cascade``: gate policies, the staged
and the fused predictor, pipeline and server wiring) against the
reference's ``repro.cascade``: the same numpy-made forests and rows
through both packages.

Quantized forests are held bit-exact (``assert_array_equal``): scores,
per-stage exit counts and classes.  Gate decisions on a logit forest
(softmax) must be identical too; the softmax probabilities themselves
meet the reference's within rtol 1e-6 (``exp`` differs between XLA's CPU
code and torch's by at most an ulp or two).  The port runs here on
``device="cpu"``: ``backend="torch"`` is the reference's ``"jax"``, and
``backend="cuda"`` runs the CUDA kernels' plain versions; the reference's
fused Pallas cascade runs in interpret mode, on a few cases only (it is
slow on the CPU).
"""
import copy

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import cascade as rc  # noqa: E402
from repro import core as rcore  # noqa: E402
from repro.inference.server import ForestServer as RServer  # noqa: E402
from repro.trees.gradient_boosting import (  # noqa: E402
    GradientBoosting as RGB, GradientBoostingConfig as RGBConfig)
from repro_torch import cascade as tc  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.inference import ForestServer as TServer  # noqa: E402
from test_conformance import ADVERSARIAL, _X, _mid_stages  # noqa: E402

CASCADE_CASES = ["mixed_stump_and_deep", "multiclass_stumps",
                 "unused_features"]
# (reference gate, port gate): never / sometimes / always firing margins,
# a probability gate and the sound bound gate
GATES = {
    "margin0": (rc.MarginGate(0.0), tc.MarginGate(0.0)),
    "margin0.5": (rc.MarginGate(0.5), tc.MarginGate(0.5)),
    "margin_inf": (rc.MarginGate(np.inf), tc.MarginGate(np.inf)),
    "proba0.6": (rc.ProbaGate(0.6), tc.ProbaGate(0.6)),
    "bound": (rc.ScoreBoundGate(), tc.ScoreBoundGate()),
}
# every port variant: (fused, backend)
VARIANTS = [(False, "torch"), (True, "torch"), (False, "cuda"),
            (True, "cuda")]
VARIANT_IDS = ["staged-torch", "fused-torch", "staged-cuda", "fused-cuda"]


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


def rows(forest, B, seed=0):
    return np.random.default_rng(seed).normal(
        0, 1.2, size=(B, forest.n_features))


def port_cascade(ref_forest, stages, policy, fused, backend, **kw):
    cls = tc.FusedCascadePredictor if fused else tc.CascadePredictor
    return cls(port(ref_forest), tc.CascadeSpec(stages, policy, fused=fused),
               backend=backend, device="cpu", **kw)


def run(casc, X):
    """A cascade's scores and exit counts on rows ``X``."""
    return casc.predict(X), casc.last_exit_counts.copy()


def assert_matches(casc, want, X, tag):
    """A port cascade's scores, exit counts and classes on rows ``X``
    against ``want``, a reference cascade's ``run``."""
    scores, counts = run(casc, X)
    np.testing.assert_array_equal(scores, want[0], err_msg=tag)
    np.testing.assert_array_equal(counts, want[1], err_msg=tag)
    np.testing.assert_array_equal(casc.predict_class(X),
                                  want[0].argmax(axis=1), err_msg=tag)


def assert_same(got, ref, X, tag):
    """Scores, exit counts and classes of a port and a reference cascade
    on rows ``X``."""
    assert_matches(got, run(ref, X), X, tag)


@pytest.fixture(scope="module")
def qclass_forest():
    """Quantized multiclass forest — test_cascade.py's fixture."""
    f = rcore.random_forest_ir(n_trees=24, n_leaves=16, n_features=8,
                               n_classes=3, seed=7, full=False)
    return rcore.quantize_forest(f, None)


@pytest.fixture(scope="module")
def gbm_forest():
    """Softmax GBM: 3 classes, logit leaves (negative and positive)."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(300, 6))
    y = np.argmax(X[:, :3] + 0.3 * rng.normal(size=(300, 3)), axis=1)
    gb = RGB(RGBConfig(n_trees=24, max_leaves=8, objective="softmax",
                       seed=0)).fit(X, y)
    forest = rcore.from_gradient_boosting(gb)
    assert not rcore.registry.votes_mode(forest)
    return forest


@pytest.fixture(scope="module")
def ref_staged(qclass_forest):
    """The reference's staged cascade on the fixture, built once (its
    stage jits are reused across policies)."""
    return rc.CascadePredictor(qclass_forest,
                               rc.CascadeSpec((6, 12, 24)))


# --------------------------------------------------------------------------- #
# stages and slices
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("stages,n", [((16, 48), 192), ((48, 16, 16), 192),
                                      ((500,), 192), ((16, 500), 192),
                                      ((192,), 192)])
def test_normalize_stages_matches_reference(stages, n):
    assert tc.normalize_stages(stages, n) == rc.normalize_stages(stages, n)
    with pytest.raises(ValueError, match="positive"):
        tc.normalize_stages((0,) + stages, n)


def test_tree_slice_matches_reference(qclass_forest):
    got = tc.tree_slice(port(qclass_forest), 8, 20)
    want = rc.tree_slice(qclass_forest, 8, 20)
    for name, value in vars(want).items():
        g = getattr(got, name)
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(g, value, err_msg=name)
        else:
            assert g == value, name


def test_spec_tags_match_reference():
    for (rg, tg) in GATES.values():
        for fused in (False, True):
            assert tc.CascadeSpec((6, 12), tg, fused=fused).tag() == \
                rc.CascadeSpec((6, 12), rg, fused=fused).tag()
    assert tc.CascadeSpec((6, 12)).tag() == rc.CascadeSpec((6, 12)).tag()


# --------------------------------------------------------------------------- #
# gate policies
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("forest_name", ["qclass_forest", "gbm_forest",
                                         "class_forest"])
@pytest.mark.parametrize("slack,decision", [(0.0, 0.0), (0.5, 0.25)])
def test_bound_gate_prepare_state_is_array_equal(forest_name, slack,
                                                 decision, request):
    forest = request.getfixturevalue(forest_name)
    stages = (4, 9, forest.n_trees)
    want = rc.ScoreBoundGate(slack=slack, decision=decision)
    got = tc.ScoreBoundGate(slack=slack, decision=decision)
    want.prepare(forest, stages)
    got.prepare(port(forest), stages)
    np.testing.assert_array_equal(got._rest_min, want._rest_min)
    np.testing.assert_array_equal(got._rest_max, want._rest_max)
    assert got._rest_min.dtype == want._rest_min.dtype == np.float32


_CUM = {}


def _cum_scores(forest, B=64, seed=3):
    """Reference cumulative stage scores (K, B, C) of the forest (made
    once per forest and batch)."""
    key = (id(forest), B, seed)
    if key not in _CUM:
        casc = rc.CascadePredictor(forest, rc.CascadeSpec((6, 12, 24)))
        _CUM[key] = (casc.cumulative_scores(rows(forest, B, seed)),
                     casc.stages)
    return _CUM[key]


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("forest_name", ["qclass_forest", "gbm_forest"])
def test_decide_and_exits_are_identical(gate, forest_name, request):
    forest = request.getfixturevalue(forest_name)
    cum, stages = _cum_scores(forest)
    want, got = (copy.copy(g) for g in GATES[gate])
    want.prepare(forest, stages)
    got.prepare(port(forest), stages)
    fired = 0
    for k in range(len(stages) - 1):
        d_want = np.asarray(want.decide(jnp.asarray(cum[k]), k))
        d_got = got.decide(torch.from_numpy(cum[k]), k).numpy()
        np.testing.assert_array_equal(d_got, d_want, err_msg=f"stage {k}")
        # exits on a survivor subset, unpadded in the port
        sub = cum[k][::3]
        np.testing.assert_array_equal(got.exits(sub, k), want.exits(sub, k))
        fired += int(d_got.sum())
    if gate == "margin0":
        assert fired > 0


def test_normalize_scores_matches_reference(qclass_forest, gbm_forest):
    votes, _ = _cum_scores(qclass_forest)
    logits, _ = _cum_scores(gbm_forest)
    for cum, is_votes in ((votes, True), (logits, False)):
        for k in range(cum.shape[0]):
            got = tc.normalize_scores_torch(torch.from_numpy(cum[k]),
                                            votes=is_votes).numpy()
            want = np.asarray(rc.normalize_scores_jnp(jnp.asarray(cum[k]),
                                                      votes=is_votes))
            if is_votes:       # integer vote mass: exact sums and quotients
                np.testing.assert_array_equal(got, want)
            else:              # exp differs by an ulp or two across libraries
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    zeros = torch.zeros((2, 4))
    np.testing.assert_array_equal(
        tc.normalize_scores_torch(zeros, votes=True).numpy(),
        np.full((2, 4), np.float32(0.25)))


def test_argmax_onehot_takes_the_first_maximum():
    from repro_torch.cascade.policy import _argmax_onehot
    s = torch.tensor([[1.0, 3.0, 3.0], [2.0, 2.0, 2.0], [0.0, -1.0, 5.0]])
    np.testing.assert_array_equal(
        _argmax_onehot(s).numpy().argmax(axis=1),
        s.numpy().argmax(axis=1))
    assert _argmax_onehot(s).sum().item() == 3


@pytest.mark.parametrize("gate", sorted(GATES) + ["bound_slack"])
def test_policy_header_config_matches_reference(gate):
    rg, tg = GATES.get(gate, (rc.ScoreBoundGate(0.5, 1.0),
                              tc.ScoreBoundGate(0.5, 1.0)))
    got, want = tc.policy_to_header(tg), rc.policy_to_header(rg)
    assert got["config"] == want["config"]
    assert got["class"].split(":")[1] == want["class"].split(":")[1]
    assert got["class"].startswith("repro_torch.cascade.policy:")
    back = tc.policy_from_header(got)
    assert back == tg and type(back) is type(tg)
    # the reference's header config builds the port's gate
    assert tc.policy_from_header({"class": got["class"],
                                  "config": want["config"]}) == tg


def test_policy_header_rejects_non_policies():
    with pytest.raises(ValueError, match="not a GatePolicy"):
        tc.policy_from_header({"class": "repro_torch.cascade:CascadeSpec",
                               "config": {}})


@pytest.mark.parametrize("gate", ["margin0.5", "proba0.6", "bound"])
def test_simulate_gate_matches_reference(gate, qclass_forest):
    cum, stages = _cum_scores(qclass_forest, B=80, seed=8)
    want, got = (copy.copy(g) for g in GATES[gate])
    want.prepare(qclass_forest, stages)
    got.prepare(port(qclass_forest), stages)
    ex_got, fin_got = tc.simulate_gate(got, cum)
    ex_want, fin_want = rc.simulate_gate(want, cum)
    np.testing.assert_array_equal(ex_got, ex_want)
    np.testing.assert_array_equal(fin_got, fin_want)


def test_calibrate_matches_reference(trained_rf, magic_ds):
    qf = rcore.quantize_forest(rcore.from_random_forest(trained_rf),
                               magic_ds.X_train)
    n = len(magic_ds.X_test) // 2
    X, y = magic_ds.X_test[:n], magic_ds.y_test[:n]
    want = rc.calibrate(rcore.compile_forest(
        qf, engine="bitvector", cascade=rc.CascadeSpec((8, 32))), X, y,
        floor_pp=0.5)
    casc = tcore.compile_forest(port(qf), engine="bitvector",
                                backend="torch", device="cpu",
                                cascade=tc.CascadeSpec((8, 32)))
    got = tc.calibrate(casc, X, y, floor_pp=0.5)
    assert got.policy.tag() == want.policy.tag()
    assert got.table == want.table
    assert (got.accuracy, got.full_accuracy, got.mean_trees) == \
        (want.accuracy, want.full_accuracy, want.mean_trees)
    assert got.exit_fractions == want.exit_fractions
    assert got.accuracy_drop_pp == want.accuracy_drop_pp
    # the winner installs and gates as the reference's does
    casc.set_policy(got.policy)
    ref = rcore.compile_forest(qf, engine="bitvector",
                               cascade=rc.CascadeSpec((8, 32)))
    ref.set_policy(want.policy)
    assert_same(casc, ref, magic_ds.X_test[n:], "calibrated winner")


# --------------------------------------------------------------------------- #
# staged and fused predictors against the reference
# --------------------------------------------------------------------------- #
_REF_OUT = {}


def _ref_staged_out(ref_staged, gate, X):
    """The reference staged cascade's (scores, exit counts) under
    ``gate`` on ``X``, computed once per gate and batch."""
    key = (gate, X.shape[0])
    if key not in _REF_OUT:
        ref_staged.set_policy(GATES[gate][0])
        _REF_OUT[key] = run(ref_staged, X)
    return _REF_OUT[key]


@pytest.mark.parametrize("fused,backend", VARIANTS, ids=VARIANT_IDS)
@pytest.mark.parametrize("gate", sorted(GATES))
def test_port_cascades_match_reference_staged(gate, fused, backend,
                                              qclass_forest, ref_staged):
    """Every port variant on the quantized fixture, every gate, at batch
    sizes that cross the 128-row kernel block."""
    casc = port_cascade(qclass_forest, (6, 12, 24), GATES[gate][1], fused,
                        backend)
    for B in (1, 127, 129, 300):
        X = rows(qclass_forest, B, seed=B)
        assert_matches(casc, _ref_staged_out(ref_staged, gate, X), X,
                       f"{gate} B={B}")
    # predict and predict_class each count every row
    assert casc.exit_counts.sum() == 2 * (1 + 127 + 129 + 300)


@pytest.mark.parametrize("case", CASCADE_CASES)
def test_port_cascades_match_reference_on_adversarial_forests(case):
    """test_conformance.py's cascade cases, quantized, with the firing
    regimes never / mixed / always and the bound gate: every port variant
    against the reference's staged loop."""
    forest = ADVERSARIAL[case]()
    X = _X(forest, B=12, seed=17)
    qf = rcore.quantize_forest(forest, X)
    stages = _mid_stages(qf)
    ref = rc.CascadePredictor(qf, rc.CascadeSpec(stages))
    for gate, (rg, tg) in GATES.items():
        ref.set_policy(rg)
        want = run(ref, X)
        for fused, backend in VARIANTS:
            casc = port_cascade(qf, stages, tg, fused, backend)
            assert_matches(casc, want, X, f"{case}/{gate}/{fused}/{backend}")


@pytest.mark.parametrize("case", CASCADE_CASES)
def test_port_fused_matches_reference_fused_and_pallas(case):
    """The reference's fused cascades — jax tier 1 and the Pallas kernel
    in interpret mode — against the port's fused tiers, one mixed gate."""
    forest = ADVERSARIAL[case]()
    X = _X(forest, B=12, seed=17)
    qf = rcore.quantize_forest(forest, X)
    stages = _mid_stages(qf)
    rg, tg = GATES["margin0.5"]
    refs = {
        "jax": rc.FusedCascadePredictor(
            qf, rc.CascadeSpec(stages, rg, fused=True)),
        "pallas": rc.FusedCascadePredictor(
            qf, rc.CascadeSpec(stages, rg, fused=True), backend="pallas",
            engine_kw={"interpret": True}),
    }
    ports = {"torch": port_cascade(qf, stages, tg, True, "torch"),
             "cuda": port_cascade(qf, stages, tg, True, "cuda")}
    for rname, ref in refs.items():
        want = run(ref, X)
        for pname, casc in ports.items():
            assert_matches(casc, want, X, f"{case} {pname} vs {rname}")


def test_batch_splitting_forest_matches_every_reference_cascade():
    """test_conformance.py's forest whose gate splits the batch: 12 trees
    x 16 leaves x 6 features, C=3, MarginGate(0.35), at batch sizes 1,
    127, 129 and 300 (the reference's jax-fused cascade, which compiles
    for seconds per batch bucket, at 129 only); the exit counts are
    non-trivial."""
    forest = rcore.random_forest_ir(12, 16, 6, n_classes=3, seed=7,
                                    full=False)
    X = np.random.default_rng(20).normal(0, 2.0, size=(300, 6))
    qf = rcore.quantize_forest(forest, X)
    stages = _mid_stages(qf)
    spec = rc.CascadeSpec(stages, rc.MarginGate(0.35))
    fspec = rc.CascadeSpec(stages, rc.MarginGate(0.35), fused=True)
    refs = [rc.CascadePredictor(qf, spec),
            rc.FusedCascadePredictor(qf, fspec, backend="pallas",
                                     engine_kw={"interpret": True})]
    jax_fused = rc.FusedCascadePredictor(qf, fspec)
    ports = [port_cascade(qf, stages, tc.MarginGate(0.35), f, b)
             for f, b in VARIANTS]
    for B in (1, 127, 129, 300):
        for ref in refs + ([jax_fused] if B == 129 else []):
            want = run(ref, X[:B])
            for casc in ports:
                assert_matches(casc, want, X[:B],
                               f"B={B} {type(casc).__name__}/{casc.backend}"
                               f" vs {type(ref).__name__}/{ref.backend}")
    counts = ports[-1].last_exit_counts
    assert 0 < counts[0] < 300, f"gate never/always fired: {counts}"


def test_logit_forest_cascades_match_reference(gbm_forest):
    """Softmax gate on a float GBM: the decisions are identical, so the
    exit counts are, and the scores agree within float tolerance (sums in
    another order)."""
    X = rows(gbm_forest, 64, seed=4)
    stages = (6, 12, 24)
    ref = rc.CascadePredictor(gbm_forest,
                              rc.CascadeSpec(stages, rc.MarginGate(0.3)))
    want = ref.predict(X)
    assert np.count_nonzero(ref.last_exit_counts) >= 2   # gate splits
    for fused, backend in VARIANTS:
        casc = port_cascade(gbm_forest, stages, tc.MarginGate(0.3), fused,
                            backend)
        np.testing.assert_allclose(casc.predict(X), want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(casc.last_exit_counts,
                                      ref.last_exit_counts)


# --------------------------------------------------------------------------- #
# twins of tests/test_cascade.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fused", [False, True])
def test_exit_counts_sum_to_batch(qclass_forest, fused):
    casc = port_cascade(qclass_forest, (6, 12), tc.MarginGate(0.3), fused,
                        "torch")
    X = rows(qclass_forest, 37)
    casc.predict(X)
    assert casc.last_exit_counts.sum() == 37
    casc.predict(X[:5])
    assert casc.last_exit_counts.sum() == 5
    assert casc.exit_counts.sum() == 42
    np.testing.assert_allclose(casc.exit_fractions.sum(), 1.0)
    assert qclass_forest.n_trees >= casc.mean_trees_evaluated >= 6


@pytest.mark.parametrize("fused,backend", VARIANTS, ids=VARIANT_IDS)
def test_gated_rows_carry_prefix_scores(qclass_forest, fused, backend):
    """A row that exits at stage k returns exactly the cumulative score of
    stages <= k (the gate simulation is the predictor's semantics)."""
    casc = port_cascade(qclass_forest, (6, 12), tc.MarginGate(0.3), fused,
                        backend)
    X = rows(qclass_forest, 40, seed=2)
    got = casc.predict(X)
    cum = casc.cumulative_scores(X)
    exit_stage, expect = tc.simulate_gate(copy.copy(casc.policy), cum)
    np.testing.assert_array_equal(got, expect)
    np.testing.assert_array_equal(
        np.bincount(exit_stage, minlength=len(casc.stages)),
        casc.last_exit_counts)


@pytest.mark.parametrize("fused,backend", VARIANTS, ids=VARIANT_IDS)
def test_empty_batch(qclass_forest, fused, backend):
    casc = port_cascade(qclass_forest, (6, 12), None, fused, backend)
    out = casc.predict(np.zeros((0, qclass_forest.n_features)))
    assert out.shape == (0, 3)
    assert casc.last_exit_counts.sum() == 0


@pytest.mark.parametrize("fused,backend", VARIANTS, ids=VARIANT_IDS)
def test_single_stage_is_the_engine(qclass_forest, fused, backend):
    casc = port_cascade(qclass_forest, (qclass_forest.n_trees,),
                        tc.MarginGate(0.0), fused, backend)
    base = tcore.compile_forest(port(qclass_forest), engine="bitvector",
                                backend=backend, device="cpu")
    X = rows(qclass_forest, 33, seed=6)
    np.testing.assert_array_equal(casc.predict(X), base.predict(X))
    assert casc.last_exit_counts.tolist() == [33]


def test_predict_proba_matches_base_when_gate_off(qclass_forest):
    base = tcore.compile_forest(port(qclass_forest), engine="bitvector",
                                backend="torch", device="cpu")
    casc = port_cascade(qclass_forest, (8, 24), tc.MarginGate(np.inf),
                        False, "torch")
    X = rows(qclass_forest, 16, seed=4)
    np.testing.assert_array_equal(casc.predict_proba(X),
                                  base.predict_proba(X))


def test_predictor_protocol(qclass_forest):
    casc = port_cascade(qclass_forest, (8, 24), None, False, "torch")
    assert isinstance(casc, tcore.Predictor)
    assert casc.host_forest() is casc.forest
    X = rows(qclass_forest, 4)
    np.testing.assert_array_equal(
        casc.transform_inputs(X), rcore.quantize_inputs(qclass_forest, X))
    with pytest.raises(NotImplementedError, match="item 9"):
        casc.trace_cache_size()


def test_stage_batches_are_bucketed(qclass_forest, monkeypatch):
    """Shrinking batches reach the stage engines at power-of-two sizes."""
    casc = port_cascade(qclass_forest, (6, 24), tc.MarginGate(np.inf),
                        False, "torch")
    seen = []
    stage0 = casc.stage_predictors[0]
    orig = stage0.predict_transformed

    def spy(X):
        seen.append(X.shape[0])
        return orig(X)

    monkeypatch.setattr(stage0, "predict_transformed", spy)
    for B in (3, 9, 15, 16):
        casc.predict(rows(qclass_forest, B))
    assert set(seen) == {4, 16}


def test_host_syncs(qclass_forest):
    stages = (6, 12, 24)
    assert port_cascade(qclass_forest, stages, None, False,
                        "torch").host_syncs == 3
    assert port_cascade(qclass_forest, stages, None, True,
                        "torch").host_syncs == 3
    assert port_cascade(qclass_forest, stages, None, True,
                        "cuda").host_syncs == 1


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_set_policy_rebuilds_program(qclass_forest, backend):
    fused = port_cascade(qclass_forest, (6, 12, 24), tc.MarginGate(np.inf),
                         True, backend)
    X = rows(qclass_forest, 20, seed=31)
    fused.predict(X)
    assert fused.last_exit_counts.tolist() == [0, 0, 20]
    fused.set_policy(tc.MarginGate(0.0))
    fused.predict(X)
    assert fused.last_exit_counts.tolist() == [20, 0, 0]


def test_bucket_ladder_matches_reference(qclass_forest):
    ref = rc.FusedCascadePredictor(qclass_forest,
                                   rc.CascadeSpec((6, 24), fused=True))
    for backend, mult in (("torch", 1), ("cuda", 128)):
        casc = port_cascade(qclass_forest, (6, 24), None, True, backend)
        ref._row_mult = mult
        assert casc._row_mult == mult
        for Bp in (16, 64, 256, 1024):
            assert casc._bucket_ladder(Bp) == ref._bucket_ladder(Bp)


# --------------------------------------------------------------------------- #
# pipeline and server wiring
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("engine,backend", [("bitmm", "torch"),
                                            ("bitvector", "cuda")])
def test_compile_forest_cascade_plan_records(qclass_forest, fused, engine,
                                             backend):
    pred = tcore.compile_forest(port(qclass_forest), engine=engine,
                                backend=backend, device="cpu",
                                cascade=tc.CascadeSpec((8, 24),
                                                       fused=fused))
    want = rcore.compile_forest(qclass_forest, engine=engine,
                                cascade=rc.CascadeSpec((8, 24),
                                                       fused=fused))
    assert isinstance(pred, tc.FusedCascadePredictor if fused
                      else tc.CascadePredictor)
    names = [r.name for r in pred.plan.records]
    assert "cascade" in names and "lower" in names
    assert "stages=8/24" in pred.plan.describe()
    assert pred.describe() == want.describe()
    assert ("(fused)" in pred.plan.describe()) == fused
    # fused and staged compute the same function: the reference's staged
    # cascade (which compiles faster than its fused one) is the yardstick
    staged = rcore.compile_forest(qclass_forest, engine=engine,
                                  cascade=rc.CascadeSpec((8, 24)))
    X = rows(qclass_forest, 20, seed=9)
    np.testing.assert_array_equal(pred.predict(X), staged.predict(X))


def test_cascade_rejects_multi_device(qclass_forest):
    with pytest.raises(ValueError, match="cascade"):
        tcore.compile_plan(port(qclass_forest), engine="bitvector",
                           backend="torch", device="cpu", n_devices=2,
                           cascade=tc.CascadeSpec((8, 24)))


@pytest.mark.parametrize("fused,backend", VARIANTS, ids=VARIANT_IDS)
def test_server_reports_exit_fractions(qclass_forest, fused, backend):
    """The port's ForestServer aggregates a cascade's exit counts as the
    reference's does, to the same fractions."""
    X = rows(qclass_forest, 24, seed=12)
    stats = []
    for server_cls, pred in (
            (TServer, tcore.compile_forest(
                port(qclass_forest), engine="bitvector", backend=backend,
                device="cpu", cascade=tc.CascadeSpec(
                    (6, 24), tc.MarginGate(0.3), fused=fused))),
            (RServer, rcore.compile_forest(
                qclass_forest, engine="bitvector", cascade=rc.CascadeSpec(
                    (6, 24), rc.MarginGate(0.3), fused=fused)))):
        srv = server_cls(pred, max_batch=8, max_wait_ms=1.0)
        for i in range(24):
            srv.submit(X[i], arrival_s=float(i) * 1e-4)
        srv.flush(now_s=1.0)
        stats.append(srv.stats)
    got, want = stats
    assert got.stage_exit_counts == want.stage_exit_counts
    assert got.summary()["exit_fractions"] == \
        want.summary()["exit_fractions"]
    assert sum(got.stage_exit_counts) == 24


def test_server_no_exit_fractions_for_plain_predictor(small_forest):
    pred = tcore.compile_forest(port(small_forest), backend="torch",
                                device="cpu")
    srv = TServer(pred, max_batch=4, max_wait_ms=1.0)
    srv.submit(np.zeros(small_forest.n_features), arrival_s=0.0)
    srv.flush(now_s=1.0)
    assert "exit_fractions" not in srv.stats.summary()
    assert srv.stats.stage_exit_counts == []
