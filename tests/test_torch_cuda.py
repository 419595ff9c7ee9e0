"""The CUDA kernels on the card: tests that need an NVIDIA GPU and nvcc.

Each test skips here, without a card.  On the card they run with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports the JAX reference,
which a GPU host need not have; this file imports only ``repro_torch``.)
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.cascade import (CascadePredictor,  # noqa: E402
                                 CascadeSpec, FusedCascadePredictor,
                                 GatePolicy, MarginGate, ProbaGate,
                                 ScoreBoundGate)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.cascade_kernel import (  # noqa: E402
    cascade_qs_forward, cascade_qs_forward_reference)
from repro_torch.kernels.flash_attention_kernel import (  # noqa: E402
    flash_attention_bshd, flash_forward, flash_forward_reference)
from repro_torch.kernels.gemm_forest_kernel import (  # noqa: E402
    gemm_forward, gemm_forward_reference)
from repro_torch.kernels.quantize_kernel import quantize_rows  # noqa: E402
from repro_torch.kernels.quickscorer_kernel import (  # noqa: E402
    qs_bitmm_forward, qs_bitmm_forward_reference, qs_forward,
    qs_forward_reference)

SHAPES = [
    # (n_trees, n_leaves, n_features, n_classes, batch): the kernel tests'
    # sweep, wide leaves and classes, and the main path's full width
    (4, 8, 4, 1, 16),
    (12, 32, 10, 3, 96),
    (6, 64, 8, 2, 33),
    (16, 32, 784, 10, 40),
    (3, 16, 5, 1, 1),
    (5, 256, 7, 16, 300),
    (1024, 64, 136, 1, 1024),
    (8, 16, 6, 1, 64),
]

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _forests(T, L, d, C, B):
    forest = core.random_forest_ir(T, L, d, n_classes=C, seed=T,
                                   full=(T % 2 == 0))
    X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
    return X, (forest, core.quantize_forest(
        forest, X, core.QuantSpec(16, int_accum=True)))


@pytest.mark.parametrize("T,L,d,C,B", SHAPES)
def test_kernel_matches_plain_version(card, T, L, d, C, B):
    X, forests = _forests(T, L, d, C, B)
    for f in forests:
        arrays = [torch.from_numpy(a).to(card) for a in ops._qs_arrays(f, 8)]
        x = torch.from_numpy(core.quantize_inputs(f, X).astype(
            np.float32)).to(card)
        out_dtype = ops._out_dtype(f, 8)
        before = qs_forward.launches
        smem_x = qs_forward.launches_by_route["smem_x"]
        got = qs_forward(x, *arrays, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert qs_forward.launches == before + 1
        assert qs_forward.launches_by_route["smem_x"] == smem_x + 1
        want = qs_forward_reference(x, *arrays, out_dtype=out_dtype)
        if out_dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            # up to 1024 f32 leaves summed in two orders
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        # deterministic: no atomics, a fixed reduction order
        assert torch.equal(got, qs_forward(x, *arrays, out_dtype=out_dtype))


@pytest.mark.parametrize("d,route", [(784, "smem_x"), (2000, "global_x")])
def test_kernel_wide_rows_take_their_route(card, d, route):
    """The mnist width stages x in shared memory; rows too wide for it
    gather x from global memory.  Both bit-exact on int16 with int
    accumulation, a float forest within the reference's tolerance, and the
    same bits from two launches."""
    X, forests = _forests(64, 64, d, 10, 300)
    for f in forests:
        arrays = [torch.from_numpy(a).to(card) for a in ops._qs_arrays(f, 8)]
        x = torch.from_numpy(core.quantize_inputs(f, X).astype(
            np.float32)).to(card)
        out_dtype = ops._out_dtype(f, 8)
        before = dict(qs_forward.launches_by_route)
        got = qs_forward(x, *arrays, out_dtype=out_dtype)
        torch.cuda.synchronize()
        want = {k: n + (k == route) for k, n in before.items()}
        assert qs_forward.launches_by_route == want
        ref = qs_forward_reference(x, *arrays, out_dtype=out_dtype)
        if out_dtype == torch.int32:
            assert torch.equal(got, ref)
        else:
            # 64 f32 leaves summed in two orders
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, qs_forward(x, *arrays, out_dtype=out_dtype))


@pytest.mark.parametrize("T,L,d,C", [(1024, 64, 136, 1), (512, 64, 784, 10)])
def test_kernel_float_sums_do_not_depend_on_the_batch(card, T, L, d, C):
    """A float forest's rows give the same bits in a batch of 455 rows as
    in one of 1024: the tree groups do not change with the batch, so each
    row's f32 sum keeps one order."""
    X, (forest, _) = _forests(T, L, d, C, 1024)
    arrays = [torch.from_numpy(a).to(card) for a in ops._qs_arrays(forest, 8)]
    x = torch.from_numpy(X.astype(np.float32)).to(card)
    whole = qs_forward(x, *arrays)
    part = qs_forward(x[:455].contiguous(), *arrays)
    assert torch.equal(part, whole[:455])


@pytest.mark.parametrize("T,L,d,C,B", SHAPES[:5])
def test_predictor_on_card_matches_cpu(card, T, L, d, C, B):
    X, forests = _forests(T, L, d, C, B)
    for f in forests:
        got = ops.cuda_qs_predictor(f, device=card).predict(X)
        want = ops.cuda_qs_predictor(f, device="cpu").predict(X)
        if f.int_accum:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_kernel_rejects_what_it_cannot_take(card):
    X, (forest, _) = _forests(2, 512, 4, 1, 8)        # 16 leafidx words
    arrays = [torch.from_numpy(a).to(card) for a in ops._qs_arrays(forest, 8)]
    x = torch.from_numpy(X.astype(np.float32)).to(card)
    with pytest.raises(ValueError, match="at most"):
        qs_forward(x, *arrays)
    with pytest.raises(ValueError, match="is on"):
        qs_forward(x.cpu(), *arrays)


def test_compile_forest_defaults_to_the_card(card):
    X, (forest, _) = _forests(8, 16, 6, 1, 64)
    pred = core.compile_forest(forest)
    assert pred.device.type == "cuda"
    before = qs_forward.launches
    pred.predict(X)
    assert qs_forward.launches == before + 1


def _bitmm_operands(f, card):
    arrays, bits, npack = ops._bitmm_arrays(f, 8)
    return ([torch.from_numpy(a).to(card) for a in arrays],
            dict(bits=bits, npack=npack, n_leaves=f.n_leaves))


def _gemm_operands(f, card):
    return [torch.from_numpy(a).to(card) for a in ops._gemm_arrays(f, 8)], {}


# engine → (wrapper, plain version, operands, predictor builder)
NEW_KERNELS = {
    "bitmm": (qs_bitmm_forward, qs_bitmm_forward_reference, _bitmm_operands,
              ops.cuda_bitmm_predictor),
    "gemm": (gemm_forward, gemm_forward_reference, _gemm_operands,
             ops.cuda_gemm_predictor),
}


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
@pytest.mark.parametrize("T,L,d,C,B", SHAPES)
def test_new_kernel_matches_plain_version(card, engine, T, L, d, C, B):
    kernel, plain, operands, _ = NEW_KERNELS[engine]
    X, forests = _forests(T, L, d, C, B)
    for f in forests:
        arrays, kw = operands(f, card)
        kw["out_dtype"] = ops._out_dtype(f, 8)
        x = torch.from_numpy(core.quantize_inputs(f, X).astype(
            np.float32)).to(card)
        before = kernel.launches
        smem_x = kernel.launches_by_route["smem_x"]
        got = kernel(x, *arrays, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert kernel.launches_by_route["smem_x"] == smem_x + 1
        want = plain(x, *arrays, **kw)
        if kw["out_dtype"] == torch.int32:
            assert torch.equal(got, want)
        else:
            # up to 1024 f32 leaves summed in two orders
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        # deterministic: no atomics, a fixed reduction order
        assert torch.equal(got, kernel(x, *arrays, **kw))


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
@pytest.mark.parametrize("T,L,d,C,B", SHAPES[:5])
def test_new_predictor_on_card_matches_cpu(card, engine, T, L, d, C, B):
    build = NEW_KERNELS[engine][3]
    X, forests = _forests(T, L, d, C, B)
    for f in forests:
        got = build(f, device=card).predict(X)
        want = build(f, device="cpu").predict(X)
        if f.int_accum:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
def test_new_kernel_rejects_what_it_cannot_take(card, engine):
    kernel, _, operands, _ = NEW_KERNELS[engine]
    X, (forest, _) = _forests(2, 512, 4, 1, 8)        # 511 nodes per tree
    arrays, kw = operands(forest, card)
    x = torch.from_numpy(X.astype(np.float32)).to(card)
    with pytest.raises(ValueError, match="at most"):
        kernel(x, *arrays, **kw)
    with pytest.raises(ValueError, match="is on"):
        kernel(x.cpu(), *arrays, **kw)


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
def test_compile_forest_engine_defaults_to_the_card(card, engine):
    kernel = NEW_KERNELS[engine][0]
    X, (forest, _) = _forests(8, 16, 6, 1, 64)
    pred = core.compile_forest(forest, engine=engine)
    assert pred.device.type == "cuda"
    before = kernel.launches
    pred.predict(X)
    assert kernel.launches == before + 1


# (n_trees, n_leaves, n_features, n_classes, full, seed): tests/test_bitmm.py's
# forest sweep (deep unbalanced trees, multiclass, stumps, 22 packed groups
# at L = 128), as chip_smoke.py's FOREST_SWEEP
FOREST_SWEEP = [
    (8, 16, 6, 1, True, 0),
    (6, 64, 8, 1, False, 1),
    (12, 32, 10, 3, False, 2),
    (10, 2, 4, 1, True, 3),
    (4, 128, 5, 2, False, 4),
]


def _kernel_run(engine, f, X, card):
    """(kernel out, plain out, x, arrays, kw) for forest f on rows X."""
    kernel, plain, operands, _ = NEW_KERNELS[engine]
    arrays, kw = operands(f, card)
    kw["out_dtype"] = ops._out_dtype(f, 8)
    x = torch.from_numpy(core.quantize_inputs(f, X).astype(
        np.float32)).to(card)
    got = kernel(x, *arrays, **kw)
    torch.cuda.synchronize()
    return got, plain(x, *arrays, **kw), x, arrays, kw


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
@pytest.mark.parametrize("T,L,d,C,full,seed", FOREST_SWEEP)
def test_new_kernel_forest_sweep_and_nan_rows(card, engine, T, L, d, C,
                                              full, seed):
    """Stumps, deep unbalanced trees and 22 packed groups: int16 bit-exact,
    float within the reference's tolerance, float rows holding NaN (which
    goes left in bitmm and right in gemm) included; one smem_x launch."""
    kernel = NEW_KERNELS[engine][0]
    forest = core.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                   full=full)
    X = np.random.default_rng(seed + 200).normal(0, 1.3, size=(24, d))
    qf = core.quantize_forest(forest, X, core.QuantSpec(16, int_accum=True))
    got, want, *_ = _kernel_run(engine, qf, X, card)
    assert torch.equal(got, want)
    X[::3, ::2] = np.nan
    routes = dict(kernel.launches_by_route)
    got, want, *_ = _kernel_run(engine, forest, X, card)
    assert kernel.launches_by_route == dict(
        routes, smem_x=routes["smem_x"] + 1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
@pytest.mark.parametrize("d,route", [(784, "smem_x"), (2000, "global_x")])
def test_new_kernel_wide_rows_take_their_route(card, engine, d, route):
    """The mnist width stages x in shared memory; rows too wide for it
    gather x from global memory.  Both bit-exact on int16, float within
    tolerance, the same bits from two launches."""
    kernel = NEW_KERNELS[engine][0]
    X, forests = _forests(64, 64, d, 10, 300)
    for f in forests:
        before = dict(kernel.launches_by_route)
        got, want, x, arrays, kw = _kernel_run(engine, f, X, card)
        assert kernel.launches_by_route == {
            k: n + (k == route) for k, n in before.items()}
        if f.int_accum:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, kernel(x, *arrays, **kw))


@pytest.mark.parametrize("engine", sorted(NEW_KERNELS))
@pytest.mark.parametrize("T,L,d,C", [(1024, 64, 136, 1), (512, 64, 784, 10)])
def test_new_kernel_float_sums_do_not_depend_on_the_batch(card, engine, T, L,
                                                          d, C):
    """A float forest's rows give the same bits in a batch of 455 rows as
    in one of 1024: the tree groups do not change with the batch."""
    kernel, _, operands, _ = NEW_KERNELS[engine]
    X, (forest, _) = _forests(T, L, d, C, 1024)
    arrays, kw = operands(forest, card)
    x = torch.from_numpy(X.astype(np.float32)).to(card)
    whole = kernel(x, *arrays, **kw)
    part = kernel(x[:455].contiguous(), *arrays, **kw)
    assert torch.equal(part, whole[:455])


@pytest.mark.parametrize("engine", ["bitvector", "bitmm", "gemm", "cascade"])
def test_compile_on_card_rejects_what_the_kernel_cannot_take(card, engine):
    """Compile, not the first batch, raises for an L = 512 forest."""
    forest = core.random_forest_ir(2, 512, 4, n_classes=1, seed=0, full=True)
    kw = dict(engine="bitvector", cascade=CascadeSpec((1, 2), fused=True)) \
        if engine == "cascade" else dict(engine=engine)
    with pytest.raises(ValueError, match='at most.*backend="torch"'):
        core.compile_forest(forest, backend="cuda", **kw)


# --------------------------------------------------------------------------- #
# cascade_qs_forward
# --------------------------------------------------------------------------- #
# (n_trees, n_leaves, n_features, n_classes, batch, stages, gate, vote
# leaves): logit leaves through the expf softmax, vote leaves, the bound
# gate where it fires (C = 3, and the C = 1 band), wide leaves and classes,
# batches across the 32-row tiles (the last two rows invalid), a first
# stage of fewer trees than a cluster has warps, and the mnist cascade's
# width
CASCADE_SHAPES = [
    (24, 16, 8, 3, 300, (6, 12, 24), MarginGate(0.3), False),
    (24, 16, 8, 3, 129, (6, 12, 24), ProbaGate(0.5), True),
    (24, 16, 8, 3, 300, (20, 22, 24), ScoreBoundGate(), True),
    (24, 16, 8, 1, 77, (20, 22, 24), ScoreBoundGate(0.5, 0.25), False),
    (12, 256, 7, 16, 33, (3, 12), MarginGate(0.1), False),
    (24, 16, 8, 3, 77, (3, 12, 24), MarginGate(0.3), False),
    (512, 64, 784, 10, 1024, (16, 64, 256, 512), MarginGate(0.3), False),
]
CASCADE_IDS = [f"{s[0]}x{s[1]}-C{s[3]}-B{s[4]}-{s[6].tag()}"
               for s in CASCADE_SHAPES]


def _cascade_forests(T, L, d, C, B, votes):
    import dataclasses
    forest = core.random_forest_ir(T, L, d, n_classes=C, seed=T + L,
                                   full=False)
    if votes:
        forest = dataclasses.replace(forest,
                                     leaf_value=np.abs(forest.leaf_value))
    X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
    return X, (forest, core.quantize_forest(
        forest, X, core.QuantSpec(16, int_accum=True)))


def _cascade_operands(f, stages, gate, X, card):
    import copy
    policy = copy.copy(gate)
    policy.prepare(f, stages)
    fn = ops.cuda_fused_cascade_qs(f, stages, policy, device=card)
    # a feat_map's column gather can leave the rows column-major
    x = torch.from_numpy(np.ascontiguousarray(core.quantize_inputs(
        f, X), dtype=np.float32)).to(card)
    valid = torch.arange(len(X), device=card) < len(X) - 2
    kw = dict(stage_bounds=fn.stage_bounds, policy=policy,
              inv_scale=1.0 / core.leaf_scale(f), out_dtype=fn.out_dtype)
    return x, valid, fn.arrays, kw


@pytest.mark.parametrize("T,L,d,C,B,stages,gate,votes", CASCADE_SHAPES,
                         ids=CASCADE_IDS)
def test_cascade_kernel_matches_plain_version(card, T, L, d, C, B, stages,
                                              gate, votes):
    """Exit stages identical (the expf softmax of logit forests included),
    scores bit-exact on int-accum forests; deterministic."""
    X, forests = _cascade_forests(T, L, d, C, B, votes)
    for f in forests:
        x, valid, arrays, kw = _cascade_operands(f, stages, gate, X, card)
        before = cascade_qs_forward.launches
        got, got_exit = cascade_qs_forward(x, valid, *arrays, **kw)
        torch.cuda.synchronize()
        assert cascade_qs_forward.launches == before + 1
        want, want_exit = cascade_qs_forward_reference(x, valid, *arrays,
                                                       **kw)
        assert torch.equal(got_exit, want_exit)
        if f.int_accum:
            assert torch.equal(got, want)
        else:
            # up to 512 f32 leaves summed in two orders
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        # invalid rows: zero scores, the last stage
        assert not got[-2:].any() and (got_exit[-2:] == len(stages) - 1).all()
        again = cascade_qs_forward(x, valid, *arrays, **kw)
        assert torch.equal(got, again[0]) and torch.equal(got_exit, again[1])


@pytest.mark.parametrize("T,L,d,C,B,stages,gate,votes", CASCADE_SHAPES,
                         ids=CASCADE_IDS)
def test_fused_cascade_on_card_matches_staged(card, T, L, d, C, B, stages,
                                              gate, votes):
    """The kernel tier against the staged cascade on the card (qs_forward
    per stage, the torch gate on the card): bit-exact on int-accum
    forests, scores and exit counts."""
    X, (_, qf) = _cascade_forests(T, L, d, C, B, votes)
    fused = FusedCascadePredictor(qf, CascadeSpec(stages, gate, fused=True),
                                  backend="cuda", device=card)
    staged = CascadePredictor(qf, CascadeSpec(stages, gate), backend="cuda",
                              device=card)
    before = cascade_qs_forward.launches
    got = fused.predict(X)
    assert cascade_qs_forward.launches == before + 1
    np.testing.assert_array_equal(got, staged.predict(X))
    np.testing.assert_array_equal(fused.last_exit_counts,
                                  staged.last_exit_counts)
    cpu = FusedCascadePredictor(qf, CascadeSpec(stages, gate, fused=True),
                                backend="cuda", device="cpu")
    np.testing.assert_array_equal(got, cpu.predict(X))


def test_cascade_float_forest_within_tolerance(card):
    X, (forest, _) = _cascade_forests(24, 16, 8, 3, 300, False)
    spec = CascadeSpec((6, 12, 24), MarginGate(0.3))
    fused = FusedCascadePredictor(forest, CascadeSpec(
        spec.stages, spec.policy, fused=True), backend="cuda", device=card)
    staged = CascadePredictor(forest, spec, backend="cuda", device=card)
    np.testing.assert_allclose(fused.predict(X), staged.predict(X),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(fused.last_exit_counts,
                                  staged.last_exit_counts)


@pytest.mark.parametrize("T,L,d,C,B", [(24, 16, 8, 3, 300),
                                       (1024, 64, 136, 1, 1024)])
def test_cascade_gate_that_never_fires_is_qs_forward(card, T, L, d, C, B):
    X, (_, qf) = _cascade_forests(T, L, d, C, B, False)
    stages = (T // 4, T // 2, T)
    x, valid, arrays, kw = _cascade_operands(qf, stages, MarginGate(np.inf),
                                             X, card)
    valid = torch.ones_like(valid)
    got, exit_stage = cascade_qs_forward(x, valid, *arrays, **kw)
    qs = [torch.from_numpy(a).to(card) for a in ops._qs_arrays(qf, 8)]
    want = qs_forward(x, *qs, out_dtype=kw["out_dtype"])
    assert torch.equal(got, want)
    assert (exit_stage == len(stages) - 1).all()


def _check_cascade(got, got_exit, want, want_exit, int_accum, atol):
    assert torch.equal(got_exit, want_exit)
    if int_accum:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("votes", [False, True])
@pytest.mark.parametrize("gate", [MarginGate(0.3), ProbaGate(0.5),
                                  ScoreBoundGate()],
                         ids=lambda g: g.tag())
def test_cascade_every_gate_matches_plain_version(card, gate, votes):
    """Every built-in gate on logit and vote leaves: exit stages identical
    to the plain version's, int16 bit-exact, float within the reference's
    rtol 1e-5 / atol 1e-6 (24 f32 leaves summed in two orders)."""
    X, forests = _cascade_forests(24, 16, 8, 3, 300, votes)
    for f in forests:
        x, valid, arrays, kw = _cascade_operands(f, (6, 12, 24), gate, X,
                                                 card)
        got, got_exit = cascade_qs_forward(x, valid, *arrays, **kw)
        want, want_exit = cascade_qs_forward_reference(x, valid, *arrays,
                                                       **kw)
        _check_cascade(got, got_exit, want, want_exit, f.int_accum, 1e-6)


@pytest.mark.parametrize("d,route", [(784, "smem_x"), (2000, "global_x")])
def test_cascade_wide_rows_take_their_route(card, d, route):
    """At the mnist cascade's leaves and classes (W = 2, C = 10), the mnist
    width stages x in shared memory; rows too wide for it gather x from
    global memory.  Both match the plain version and give the same bits
    from two launches."""
    from repro_torch.kernels import cascade_kernel as ck
    X, forests = _cascade_forests(64, 64, d, 10, 300, False)
    stages = (8, 32, 64)
    for f in forests:
        x, valid, arrays, kw = _cascade_operands(f, stages, MarginGate(0.3),
                                                 X, card)
        lay = ck.cascade_layout(d, arrays[0].shape[1], arrays[2].shape[-1],
                                10)
        assert lay.route == route
        before = dict(cascade_qs_forward.launches_by_route)
        got, got_exit = cascade_qs_forward(x, valid, *arrays, **kw)
        torch.cuda.synchronize()
        assert cascade_qs_forward.launches_by_route == {
            k: n + (k == route) for k, n in before.items()}
        want, want_exit = cascade_qs_forward_reference(x, valid, *arrays,
                                                       **kw)
        _check_cascade(got, got_exit, want, want_exit, f.int_accum, 1e-5)
        again = cascade_qs_forward(x, valid, *arrays, **kw)
        assert torch.equal(got, again[0]) and torch.equal(got_exit, again[1])


def test_cascade_rows_do_not_depend_on_the_batch(card):
    """A float forest at the mnist cascade's shape: a row's scores and exit
    stage have the same bits in a batch of 1024 rows and in one of 33
    (each stage's trees are split over the cluster by the forest alone)."""
    X, (forest, _) = _cascade_forests(512, 64, 784, 10, 1024, False)
    x, valid, arrays, kw = _cascade_operands(
        forest, (16, 64, 256, 512), MarginGate(0.3), X, card)
    valid = torch.ones_like(valid)
    whole, whole_exit = cascade_qs_forward(x, valid, *arrays, **kw)
    part, part_exit = cascade_qs_forward(x[:33].contiguous(), valid[:33],
                                         *arrays, **kw)
    assert torch.equal(part, whole[:33])
    assert torch.equal(part_exit, whole_exit[:33])
    assert (whole_exit < 3).any()          # the gate fired


class _NumpyOnlyGate(GatePolicy):
    def exits(self, scores, stage):
        return scores[:, 0] > 0

    def tag(self):
        return "numpy-only"


def test_cascade_kernel_rejects_a_third_party_policy(card):
    X, (_, qf) = _cascade_forests(24, 16, 8, 3, 16, False)
    with pytest.raises(NotImplementedError, match="fused=False"):
        core.compile_forest(qf, engine="bitvector", backend="cuda",
                            cascade=CascadeSpec((12, 24), _NumpyOnlyGate(),
                                                fused=True))
    x, valid, arrays, kw = _cascade_operands(qf, (12, 24), MarginGate(0.3),
                                             X, card)
    with pytest.raises(NotImplementedError, match="_NumpyOnlyGate"):
        cascade_qs_forward(x, valid, *arrays,
                           **dict(kw, policy=_NumpyOnlyGate()))
    staged = core.compile_forest(qf, engine="bitvector", backend="cuda",
                                 cascade=CascadeSpec((12, 24),
                                                     _NumpyOnlyGate()))
    assert staged.predict(X).shape == (16, 3)


def test_compile_forest_fused_cascade_defaults_to_the_card(card):
    X, (_, qf) = _cascade_forests(24, 16, 8, 3, 64, False)
    pred = core.compile_forest(qf, engine="bitvector", backend="cuda",
                               cascade=CascadeSpec((6, 24), fused=True))
    assert pred.device.type == "cuda" and pred.host_syncs == 1
    before = cascade_qs_forward.launches
    pred.predict(X)
    assert cascade_qs_forward.launches == before + 1


# --------------------------------------------------------------------------- #
# quantize_rows: the input transform on the card
# --------------------------------------------------------------------------- #
def _grid_case(T, d, bits, n, dtype, seed, nan_rows=False):
    """A quantized forest over d features and n caller rows in ``dtype``
    with NaN, ±inf, -0.0 and the grid's ends among them."""
    forest = core.random_forest_ir(T, 64, d, seed=seed, full=True)
    rng = np.random.default_rng(seed)
    qf = core.quantize_forest(forest, rng.normal(0, 1.3, size=(500, d)),
                              core.QuantSpec(bits, int_accum=True))
    X = rng.normal(0, 1.3, size=(n, d)).astype(dtype)
    X[0] = np.resize([np.nan, np.inf, -np.inf, -0.0, 0.0], d)
    X[1 % n] = qf.feat_lo
    X[2 % n] = qf.feat_hi
    if nan_rows:
        X[::3, ::2] = np.nan
    return qf, X


def _host_feed(qf, X, rows):
    want = np.zeros((rows, qf.n_features), dtype=np.float32)
    with np.errstate(invalid="ignore"):
        want[:len(X)] = core.quantize_inputs(qf, X).astype(np.float32)
    return want


# (d, n, bucket): the MSN bulk call, the cascade's magic call and the
# query cell's buckets
QUANTIZE_SHAPES = [(136, 8192, 8192), (10, 65536, 65536), (136, 8, 128),
                   (136, 100, 128), (136, 200, 256), (136, 500, 512),
                   (136, 1024, 1024)]


def _laid_out(X, layout):
    """Row-major rows, or rows of a column-major array (a data frame's
    values, sliced), as the magic cell sends them."""
    if layout == "rows":
        return X
    return np.asfortranarray(np.concatenate([X, X[:3]]))[:len(X)]


@pytest.mark.parametrize("layout", ["rows", "column-slice"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("d,n,rows", QUANTIZE_SHAPES)
def test_quantize_rows_kernel_matches_host_transform(card, d, n, rows,
                                                     dtype, layout):
    """The kernel's feed equals ``quantize_inputs(...).astype(f32)`` bit
    for bit, padding rows +0.0, at the cells' shapes, from row-major rows
    and from a block of a column-major array; one launch."""
    qf, X = _grid_case(8, d, 16, n, dtype, seed=d + n)
    X = _laid_out(X, layout)
    before = quantize_rows.launches
    feed = ops.InputGrid(qf, card).feed(X, rows)
    torch.cuda.synchronize()
    assert quantize_rows.launches == before + 1 and feed.n == n
    got = feed.x.cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _host_feed(qf, X, rows).view(np.uint32))


@pytest.mark.parametrize("bits", [16, 8])
def test_quantize_rows_kernel_nan_rows_and_int8_grid(card, bits):
    """Rows full of NaN take the host cast's value; the control's int8
    grid clips where NumPy clips; a feat_map gathers the caller's
    columns."""
    import dataclasses
    qf, X = _grid_case(8, 136, bits, 300, np.float32, seed=bits,
                       nan_rows=True)
    feed = ops.InputGrid(qf, card).feed(X, 512)
    np.testing.assert_array_equal(feed.x.cpu().numpy().view(np.uint32),
                                  _host_feed(qf, X, 512).view(np.uint32))
    cols = np.random.default_rng(bits).permutation(150)[:136]
    mapped = dataclasses.replace(qf, feat_map=cols, n_features_src=150)
    Xw = np.random.default_rng(1).normal(size=(300, 150)).astype(np.float32)
    Xw[::4, cols[::3]] = np.nan
    feed = ops.InputGrid(mapped, card).feed(Xw, 512)
    np.testing.assert_array_equal(
        feed.x.cpu().numpy().view(np.uint32),
        _host_feed(mapped, Xw, 512).view(np.uint32))


@pytest.mark.parametrize("engine", ["qs", "bitmm", "gemm"])
def test_predict_on_card_quantizes_on_card(card, engine):
    """``predict`` on the card (raw rows copied once, ``quantize_rows``,
    the forest kernel) equals ``predict_transformed`` of the host's
    transform bit for bit, f32 and f64 callers and NaN rows; one
    ``quantize_rows`` launch a call."""
    build = {"qs": ops.cuda_qs_predictor, "bitmm": ops.cuda_bitmm_predictor,
             "gemm": ops.cuda_gemm_predictor}[engine]
    for dtype, nan_rows in ((np.float32, False), (np.float64, True)):
        qf, X = _grid_case(64, 136, 16, 300, dtype, seed=7,
                           nan_rows=nan_rows)
        X = _laid_out(X, "column-slice" if nan_rows else "rows")
        pred = build(qf, device=card)
        assert pred.grid is not None
        before = quantize_rows.launches
        got = pred.predict(X)
        assert quantize_rows.launches == before + 1
        with np.errstate(invalid="ignore"):
            host = core.quantize_inputs(qf, X).astype(np.float32)
        np.testing.assert_array_equal(got, pred.predict_transformed(host))
        assert quantize_rows.launches == before + 1


@pytest.mark.parametrize("engine", ["bitvector", "bitmm"],
                         ids=["kernel-tier", "generic-tier"])
def test_fused_cascade_quantizes_on_card(card, engine):
    """Both fused tiers on the card: scores and exit counts of the card
    feed equal the host feed's (the same predictor with its grid off);
    one ``quantize_rows`` launch a call."""
    X, (_, qf) = _cascade_forests(24, 16, 8, 3, 300, False)
    X[::7, ::3] = np.nan
    X = _laid_out(X, "column-slice")
    spec = CascadeSpec((6, 12, 24), MarginGate(0.3), fused=True)
    fused = FusedCascadePredictor(qf, spec, engine=engine, backend="cuda",
                                  device=card)
    assert fused._grid is not None
    before = quantize_rows.launches
    got = fused.predict(X)
    counts = fused.last_exit_counts.copy()
    assert quantize_rows.launches == before + 1
    fused._grid = None
    with np.errstate(invalid="ignore"):
        want = fused.predict(X)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(counts, fused.last_exit_counts)
    assert not any("grid" in vars(p) for p in fused.stage_predictors)


# --------------------------------------------------------------------------- #
# flash_forward and the LM path
# --------------------------------------------------------------------------- #
# (B, Sq, Sk, H, K, hd, causal): tests/test_flash_kernel.py's sweep, ragged
# edges no tile divides, the dense configs' head dims (64, 96, 128), and
# the served smollm-360m prefill shape
FLASH_SHAPES = [
    (1, 32, 32, 4, 4, 8, True),
    (2, 64, 64, 6, 2, 16, True),
    (2, 64, 64, 8, 1, 16, True),
    (1, 48, 96, 4, 4, 8, False),
    (2, 128, 128, 15, 5, 4, True),
    (2, 300, 300, 15, 5, 64, True),
    (1, 77, 131, 4, 2, 96, True),
    (1, 131, 77, 8, 8, 128, False),
    (8, 1024, 1024, 15, 5, 64, True),
]


def _flash_inputs(B, Sq, Sk, H, K, hd, card, dtype):
    g = torch.Generator(device="cpu").manual_seed(Sq * 31 + Sk + hd)
    q, k, v = (torch.randn(B, s, h, hd, generator=g).to(card, dtype)
               for s, h in ((Sq, H), (Sk, K), (Sk, K)))
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", FLASH_SHAPES)
def test_flash_kernel_matches_plain_version(card, dtype, B, Sq, Sk, H, K, hd,
                                            causal):
    """f32 (the CUDA-core kernel) at the reference's 2e-5, bf16 (the
    wgmma kernel) at its 3e-2; two launches give the same bits."""
    q, k, v = _flash_inputs(B, Sq, Sk, H, K, hd, card, getattr(torch, dtype))
    before = flash_forward.launches
    routes = dict(flash_forward.launches_by_route)
    got = flash_attention_bshd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 1
    route = "wgmma" if dtype == "bfloat16" else "simt"
    routes[route] += 1
    assert flash_forward.launches_by_route == routes
    assert got.dtype == q.dtype and got.shape == q.shape
    qh, kh, vh = (t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
                  for t in (q, k, v))
    want = flash_forward_reference(qh, kh, vh, causal=causal, n_rep=H // K)
    want = want.reshape(B, H, Sq, hd).transpose(1, 2)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert torch.equal(got, flash_attention_bshd(q, k, v, causal=causal))


# (B, Sq, Sk, H, K, hd, q_offset): query chunks of a longer sequence, as
# a rank of the sharded prefill's "seq" attention holds them: smollm-360m's
# rank shape on (2, 2) (15/5 heads, a 256-row chunk at 256 over 512 keys),
# a mid-sequence chunk no tile divides, and the first and last chunks
# (offset 0; offset Sk - Sq) at a narrow head width
FLASH_OFFSET_SHAPES = [
    (2, 256, 512, 15, 5, 64, 256),
    (1, 77, 300, 4, 2, 96, 101),
    (2, 40, 200, 6, 2, 16, 0),
    (2, 40, 200, 6, 2, 16, 160),
    (1, 64, 192, 8, 8, 128, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,off", FLASH_OFFSET_SHAPES)
def test_flash_kernel_query_offset_matches_plain_version(card, dtype, B, Sq,
                                                         Sk, H, K, hd, off):
    """Causal with ``q_offset`` on both routes (f32 ``simt``, bf16
    ``wgmma``) against the plain version at the tolerances of
    ``test_flash_kernel_matches_plain_version``; the rows equal the same
    rows of the whole sequence's attention (within the same bound)."""
    q, k, v = _flash_inputs(B, Sk, Sk, H, K, hd, card, getattr(torch, dtype))
    chunk = q[:, off:off + Sq].contiguous()
    before = flash_forward.launches
    got = flash_attention_bshd(chunk, k, v, causal=True, q_offset=off)
    torch.cuda.synchronize()
    assert flash_forward.launches == before + 1
    qh, kh, vh = (t.transpose(1, 2).reshape(-1, t.shape[1], hd).contiguous()
                  for t in (chunk, k, v))
    want = flash_forward_reference(qh, kh, vh, causal=True, n_rep=H // K,
                                   q_offset=off)
    want = want.reshape(B, H, Sq, hd).transpose(1, 2)
    tol = 2e-5 if dtype == "float32" else 3e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    whole = flash_attention_bshd(q, k, v, causal=True)[:, off:off + Sq]
    torch.testing.assert_close(got.float(), whole.float(), rtol=tol,
                               atol=tol)
    assert torch.equal(got, flash_attention_bshd(chunk, k, v, causal=True,
                                                 q_offset=off))


def test_flash_kernel_rejects_what_it_cannot_take(card):
    q, k, v = _flash_inputs(1, 8, 8, 2, 2, 32, card, torch.float32)
    with pytest.raises(ValueError, match="head_dim 32"):
        flash_attention_bshd(q, k, v)
    q, k, v = _flash_inputs(1, 8, 8, 2, 2, 64, card, torch.float32)
    with pytest.raises(ValueError, match="is on"):
        flash_attention_bshd(q, k.cpu(), v)
    with pytest.raises(ValueError, match="16-byte"):
        flash_forward(_misaligned(card), k.reshape(2, 8, 64),
                      v.reshape(2, 8, 64))
    before = flash_forward.launches
    with pytest.raises(ValueError, match="q_offset 1"):
        flash_attention_bshd(q, k, v, causal=True, q_offset=1)
    assert flash_forward.launches == before


def _misaligned(card):
    """A contiguous (2, 8, 64) f32 view that starts 4 bytes into its
    storage."""
    return torch.zeros(2 * 8 * 64 + 1, device=card)[1:].view(2, 8, 64)


@pytest.mark.parametrize("name", ["smollm_360m", "starcoder2_3b"])
def test_lmserver_on_card_launches_flash_per_attention_layer(card, name):
    """A reduced dense config served on the card: one flash_forward
    launch per attention layer per generate, and the same greedy tokens
    as backend="torch" (f32 model); in bf16 every launch takes the wgmma
    route."""
    from repro_torch.configs import get_config
    from repro_torch.inference import LMServer
    from repro_torch.models import Model
    cfg = get_config(name).reduced()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32)
    outs = {}
    for backend in ("cuda", "torch"):
        model = Model(cfg, torch.float32, backend=backend)
        assert model.device.type == "cuda"
        params = model.init_params(0)
        server = LMServer(model, params, batch=2, max_len=56)
        before = flash_forward.launches
        outs[backend] = server.generate(prompts, 16)
        want = cfg.n_layers if backend == "cuda" else 0
        assert flash_forward.launches - before == want
    routes = dict(flash_forward.launches_by_route)
    model = Model(cfg, torch.bfloat16, backend="cuda")
    LMServer(model, model.init_params(0), batch=2, max_len=56).generate(
        prompts, 4)
    assert flash_forward.launches_by_route == dict(
        routes, wgmma=routes["wgmma"] + cfg.n_layers)
    np.testing.assert_array_equal(outs["cuda"], outs["torch"])


# --------------------------------------------------------------------------- #
# optimized and packed forests on the card
# --------------------------------------------------------------------------- #
def _optimizable(T=64, L=32, d=784, C=3, B=150, seed=0):
    """An int16 int-accum forest every -O2 pass changes: every other
    tree's root-left child repeats the root's split at a higher threshold
    (dedup: ragged trees), trees 2 and 5 have all-zero leaves (merged to
    constants, dropped by compact), every tree's two rightmost leaves agree
    (merge: ``L`` shrinks), 64 trees of 31 nodes read part of 784 columns
    (drop: ``d`` shrinks), and leaf spreads differ (reorder)."""
    import dataclasses
    f = core.random_forest_ir(T, L, d, n_classes=C, seed=seed)
    feature, threshold = f.feature.copy(), f.threshold.copy()
    feature[::2, 1] = feature[::2, 0]
    threshold[::2, 1] = threshold[::2, 0] + 1.0
    lv = f.leaf_value.copy()
    lv[:, -1] = lv[:, -2]
    lv[[2, 5]] = 0.0
    lv *= np.linspace(0.2, 3.0, T)[:, None, None].astype(np.float32)
    f = dataclasses.replace(f, feature=feature, threshold=threshold,
                            leaf_value=lv)
    X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
    return core.quantize_forest(f, X, core.QuantSpec(16, int_accum=True)), X


@pytest.mark.parametrize("level", [1, 2])
def test_optimized_forest_runs_bit_exact_through_every_kernel(card, level):
    """-O1 / -O2 forests (fewer trees, smaller L, ragged trees, and at -O2
    fewer columns behind ``feat_map``) through ``qs_forward``,
    ``qs_bitmm_forward``, ``gemm_forward`` and the fused
    ``cascade_qs_forward``: bit-exact against their plain versions, and
    the compiled -O predictors equal -O0 on the card."""
    from repro_torch import optim
    qf, X = _optimizable()
    of = optim.optimize(qf, level, ctx={"X_calib": X}).forest
    assert of.n_trees < qf.n_trees and of.n_leaves < qf.n_leaves
    assert (of.n_nodes < of.n_leaves - 1).any()
    assert (of.n_features < qf.n_features) == (level == 2)
    x = torch.from_numpy(np.ascontiguousarray(core.quantize_inputs(
        of, X), dtype=np.float32)).to(card)
    assert x.shape[1] == of.n_features
    kernels = {"bitvector": (qs_forward, qs_forward_reference,
                             lambda f, c: ([torch.from_numpy(a).to(c)
                                            for a in ops._qs_arrays(f, 8)],
                                           {}))}
    kernels.update({e: v[:3] for e, v in NEW_KERNELS.items()})
    for engine, (kernel, plain, operands) in kernels.items():
        arrays, kw = operands(of, card)
        kw["out_dtype"] = ops._out_dtype(of, 8)
        before = kernel.launches
        got = kernel(x, *arrays, **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1, engine
        assert torch.equal(got, plain(x, *arrays, **kw)), engine
    stages = (8, 24, of.n_trees)
    xc, valid, arrays, kw = _cascade_operands(of, stages, MarginGate(0.3),
                                              X, card)
    got, got_exit = cascade_qs_forward(xc, valid, *arrays, **kw)
    want, want_exit = cascade_qs_forward_reference(xc, valid, *arrays, **kw)
    assert torch.equal(got, want) and torch.equal(got_exit, want_exit)
    base = core.compile_forest(qf, engine="bitvector", backend="torch",
                               device=card).predict(X)
    for engine in kernels:
        np.testing.assert_array_equal(core.compile_forest(
            qf, engine=engine, backend="cuda", device=card,
            opt=level).predict(X), base, err_msg=engine)


def test_optimized_fused_cascade_on_card_matches_staged(card):
    """A -O2 cascade served fused on the card (one ``cascade_qs_forward``
    launch) equals the -O2 staged cascade in plain torch: scores and exit
    counts; the stage boundaries clamp to the compacted forest."""
    qf, X = _optimizable()
    spec = dict(stages=(16, 48, 64), policy=MarginGate(0.3))
    fused = core.compile_plan(qf, engine="bitvector", backend="cuda",
                              device=card, opt=2, X_calib=X,
                              cascade=CascadeSpec(**spec, fused=True))
    staged = core.compile_plan(qf, engine="bitvector", backend="torch",
                               device=card, opt=2, X_calib=X,
                               cascade=CascadeSpec(**spec))
    assert fused.stages[-1] == fused.forest.n_trees < qf.n_trees
    before = cascade_qs_forward.launches
    got = fused.predict(X)
    assert cascade_qs_forward.launches == before + 1
    np.testing.assert_array_equal(got, staged.predict(X))
    np.testing.assert_array_equal(fused.last_exit_counts,
                                  staged.last_exit_counts)


@pytest.mark.parametrize("engine", ["bitvector", "bitmm", "gemm"])
def test_packed_file_compiles_to_the_in_memory_forest(card, engine,
                                                      tmp_path):
    """A forest written with ``io.save_forest`` and compiled from the file
    at -O2 gives the same kernel operands and the same bits as the forest
    compiled in memory."""
    from repro_torch import io
    qf, X = _optimizable(seed=1)
    path = str(tmp_path / "forest.repro.npz")
    io.save_forest(qf, path)
    from_file = core.compile_plan(path, engine=engine, backend="cuda",
                                  device=card, opt=2, X_calib=X)
    in_memory = core.compile_plan(qf, engine=engine, backend="cuda",
                                  device=card, opt=2, X_calib=X)
    assert len(from_file.arrays) == len(in_memory.arrays)
    for a, b in zip(from_file.arrays, in_memory.arrays):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(from_file.predict(X),
                                  in_memory.predict(X))


# --------------------------------------------------------------------------- #
# the autotuner on the card
# --------------------------------------------------------------------------- #
KERNEL_TUNE_NAMES = ("cuda-qs", "cuda-bitmm", "cuda-gemm")


def test_sweep_over_the_kernels_picks_a_bit_exact_winner(card, tmp_path):
    from repro_torch.core import engine_select
    engine_select.clear_cache()
    X, (_, qf) = _forests(64, 32, 20, 3, 256)
    before = {e: k.launches for e, k in (("cuda-qs", qs_forward),
                                         ("cuda-bitmm", qs_bitmm_forward),
                                         ("cuda-gemm", gemm_forward))}
    choice = engine_select.choose(qf, 256, engines=KERNEL_TUNE_NAMES,
                                  cache_path=str(tmp_path / "c.json"),
                                  repeats=2)
    assert set(choice.timings) == set(KERNEL_TUNE_NAMES)
    for name, k in (("cuda-qs", qs_forward), ("cuda-bitmm", qs_bitmm_forward),
                    ("cuda-gemm", gemm_forward)):
        # build's first predict, the warm-up and two timed calls
        assert k.launches - before[name] == 4, name
    plain = core.compile_forest(qf, engine=choice.predictor.plan.engine,
                                backend="cuda", device="cpu")
    np.testing.assert_array_equal(choice.predict(X), plain.predict(X))
    assert choice.key.startswith("torch-cuda_")


def test_from_forest_on_card_serves_what_predict_gives(card, tmp_path):
    from repro_torch.inference import ForestServer
    X, (_, qf) = _forests(32, 16, 12, 1, 64)
    srv = ForestServer.from_forest(qf, max_batch=64,
                                   engines=KERNEL_TUNE_NAMES + ("qs",),
                                   cache_path=str(tmp_path / "c.json"),
                                   repeats=1)
    for row in X:
        srv.submit(row, arrival_s=0.0)
    served = np.stack([r.result for r in srv.flush(now_s=1.0)])
    np.testing.assert_array_equal(served, srv.predictor.predict(X))
    assert srv.engine_choice.predictor is srv.predictor


def test_device_fingerprint_names_the_card(card):
    from repro_torch.core import engine_select
    fp = engine_select.device_fingerprint()
    major, minor = torch.cuda.get_device_capability()
    assert fp["backend"] == "torch-cuda"
    assert fp["device_kind"] == \
        f"{torch.cuda.get_device_name()} sm_{major}{minor}"
    assert engine_select.default_engines()[-3:] == KERNEL_TUNE_NAMES


def _fleet(card):
    """A small four-tenant fleet on the card: an int16 forest on each
    kernel engine and a fused int16 cascade on ``cascade_qs_forward``."""
    X, (_, qf) = _forests(24, 32, 12, 3, 200)
    preds = {f"k-{e}": core.compile_forest(qf, engine=e, backend="cuda")
             for e in ("bitvector", "bitmm", "gemm")}
    preds["casc"] = core.compile_forest(qf, backend="cuda", cascade=
                                        CascadeSpec((6, 12, 24),
                                                    MarginGate(0.3),
                                                    fused=True))
    return X, preds


KERNEL_OF = {"k-bitvector": qs_forward, "k-bitmm": qs_bitmm_forward,
             "k-gemm": gemm_forward, "casc": cascade_qs_forward}


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["manual", "threaded"])
def test_runtime_fleet_on_card_one_launch_per_batch(card, threaded):
    """Four tenants served on the card (manual pump or the worker thread):
    served == predict bit for bit, each kernel launched once per batch of
    its tenant, and no first use after warmup."""
    from repro_torch.inference import ServingRuntime
    from repro_torch.obs import MetricsRegistry
    X, preds = _fleet(card)
    rt = ServingRuntime(obs=MetricsRegistry())
    for tid, pred in preds.items():
        rt.add_model(tid, pred, max_batch=64, max_wait_ms=1.0)
    rt.warmup()
    before = {tid: k.launches for tid, k in KERNEL_OF.items()}
    reqs = []
    if threaded:
        with rt:
            for i, x in enumerate(X):
                reqs.append(rt.submit(list(preds)[i % 4], x))
            for r in reqs:
                r.wait(timeout=60)
    else:
        for i, x in enumerate(X):
            reqs.append(rt.submit(list(preds)[i % 4], x,
                                  arrival_s=i * 1e-4))
            rt.pump(now_s=i * 1e-4)
        rt.flush(now_s=1.0)
    stats = rt.stats()
    for tid, pred in preds.items():
        mine = [(i, r) for i, r in enumerate(reqs) if r.tenant == tid]
        idx = [i for i, _ in mine]
        launched = KERNEL_OF[tid].launches - before[tid]
        assert launched == stats[tid]["n_batches"] > 0, tid
        assert stats[tid]["compile_events"] == 0, tid
        assert stats[tid]["retrace_anomalies"] == 0, tid
        np.testing.assert_array_equal(np.stack([r.result for _, r in mine]),
                                      pred.predict(X[idx]))


def test_runtime_worker_thread_launch_error_resolves_futures(card):
    """A launch that raises in the worker thread resolves its batch with
    the error and the worker serves the next batch on the kernel."""
    from repro_torch.inference import ServingRuntime
    X, preds = _fleet(card)
    pred = preds["k-bitvector"]
    good = pred.arrays

    class Broken:
        def predict(self, X_):
            pred.arrays = good[:1] + tuple(a.cpu() for a in good[1:])
            try:
                return pred.predict(X_)
            finally:
                pred.arrays = good

        def host_forest(self):
            return pred.host_forest()

    rt = ServingRuntime(obs=False)
    rt.add_model("bad", Broken(), max_batch=8, max_wait_ms=0.0)
    rt.add_model("ok", pred, max_batch=8, max_wait_ms=0.0)
    with rt:
        bad = rt.submit("bad", X[0])
        with pytest.raises(ValueError, match="cpu"):
            bad.wait(timeout=60)
        ok = rt.submit("ok", X[0])
        np.testing.assert_array_equal(ok.wait(timeout=60),
                                      pred.predict(X[:1])[0])


# --------------------------------------------------------------------------- #
# tree-sharded execution and the moe, ssm and hybrid LM families on the card
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", ["bitvector", "bitmm", "rapidscorer",
                                    "native", "gemm"])
def test_tree_sharded_on_one_card_is_exact(card, engine):
    """Four shards on cuda:0 (T = 30 pads to 32) are bit-identical to one
    shard on int16 int-accum forests, and to the qs_forward kernel."""
    from repro_torch.core import shard
    X, (forest, qforest) = _forests(30, 32, 10, 3, 96)
    one = shard.tree_sharded(qforest, engine, devices=[card])
    four = shard.tree_sharded(qforest, engine, devices=[card] * 4)
    assert all(m.device == card for m in four.shards)
    want = one.predict(X)
    np.testing.assert_array_equal(four.predict(X), want)
    np.testing.assert_array_equal(
        core.compile_forest(qforest, device=card).predict(X), want)
    with pytest.raises(ValueError, match="devices visible"):
        core.compile_plan(qforest, engine=engine, backend="torch",
                          device=card,
                          n_devices=torch.cuda.device_count() + 1)


@pytest.mark.parametrize("name", ["mamba2_370m", "jamba_1_5_large_398b",
                                  "phi3_5_moe_42b"])
def test_lm_families_on_card_launch_flash_per_attention_layer(card, name):
    """A reduced moe, ssm or hybrid config served on the card: one
    flash_forward launch per attention layer per generate (none for the
    ssm family), and the same greedy tokens as backend="torch" (f32)."""
    from repro_torch.configs import get_config
    from repro_torch.inference import LMServer
    from repro_torch.models import Model
    cfg = get_config(name).reduced()
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 140)).astype(np.int32)
    outs = {}
    for backend in ("cuda", "torch"):
        model = Model(cfg, torch.float32, backend=backend)
        na, _ = model.mixer_counts()
        server = LMServer(model, model.init_params(0), batch=2, max_len=150)
        before = flash_forward.launches
        outs[backend] = server.generate(prompts, 8)
        want = na * model.n_units if backend == "cuda" else 0
        assert flash_forward.launches - before == want
    np.testing.assert_array_equal(outs["cuda"], outs["torch"])


# --------------------------------------------------------------------------- #
# the encdec family and the int8 KV cache on the card
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_prefill_on_card_launches_flash_per_attention(card, dtype):
    """Reduced seamless-m4t-large-v2 on the card: ``init_decode_state``
    encodes (one non-causal launch per encoder layer), the prefill with
    that state launches once per decoder layer for the causal
    self-attention and once for the cross-attention (Sq != Sk), all on
    the dtype's route; decode launches nothing.  In f32 the greedy tokens
    equal ``backend="torch"``'s and the prefill logits agree."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = get_config("seamless_m4t_large_v2").reduced()
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    enc = rng.normal(size=(2, 40, cfg.d_model)).astype(np.float32)
    route = "wgmma" if dtype == "bfloat16" else "simt"
    outs, logits = {}, {}
    for backend in ("cuda", "torch"):
        model = Model(cfg, dt, backend=backend)
        params = model.init_params(0)
        before = flash_forward.launches
        routes = dict(flash_forward.launches_by_route)
        state = model.init_decode_state(2, 20, params=params,
                                        enc_embeds=enc)
        after_encode = flash_forward.launches
        logits[backend] = model.prefill(params, prompts, state).float()
        tok = logits[backend].argmax(-1)
        toks = [tok]
        for _ in range(6):
            lg, state = model.decode_step(params, state, tok[:, None])
            tok = lg.float().argmax(-1)
            toks.append(tok)
        outs[backend] = torch.stack(toks, 1).cpu().numpy()
        n = flash_forward.launches - before
        if backend == "cuda":
            assert after_encode - before == cfg.enc_layers == 2
            assert n == cfg.enc_layers + 2 * cfg.n_layers == 6
            routes[route] += n
            assert flash_forward.launches_by_route == routes
        else:
            assert n == 0
    if dtype == "float32":
        np.testing.assert_array_equal(outs["cuda"], outs["torch"])
        torch.testing.assert_close(logits["cuda"], logits["torch"],
                                   rtol=1e-4, atol=1e-4)


def test_int8_lmserver_on_card_matches_cpu(card):
    """``LMServer(kv_quant=True)`` on the card, f32 reduced smollm with
    one set of weights: the same greedy tokens as on the CPU (the kernel
    against its plain version), one flash launch per layer, the int8
    state on the card."""
    from repro_torch.configs import get_config
    from repro_torch.inference import LMServer
    from repro_torch.models import Model
    from repro_torch.models.model import tree_map
    cfg = get_config("smollm_360m").reduced()
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 40)).astype(np.int32)
    cpu = Model(cfg, torch.float32, backend="cuda", device="cpu")
    params = cpu.init_params(0)
    want = LMServer(cpu, params, batch=2, max_len=56,
                    kv_quant=True).generate(prompts, 12)
    model = Model(cfg, torch.float32, backend="cuda")
    on_card = tree_map(lambda t: t.to(card), params)
    server = LMServer(model, on_card, batch=2, max_len=56, kv_quant=True)
    before = flash_forward.launches
    got = server.generate(prompts, 12)
    assert flash_forward.launches - before == cfg.n_layers
    np.testing.assert_array_equal(got, want)
    state = model.init_decode_state(2, 8, kv_quant=True)
    assert state["k"].dtype == torch.int8 and state["k"].is_cuda



def _train_pair(card, dtype=torch.float32, **kw):
    """The same reduced smollm Trainer on the CPU and on the card, from
    one state (made on the CPU and copied)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer
    from repro_torch.models.model import tree_map
    cfg = get_config("smollm_360m").reduced()
    cpu = Trainer(cfg, batch=2, seq_len=32, compute_dtype=dtype,
                  device="cpu", **kw)
    cpu.init_state(0)
    gpu = Trainer(cfg, batch=2, seq_len=32, compute_dtype=dtype, **kw)
    gpu.params, gpu.opt_state, gpu.residuals = (
        tree_map(lambda t: t.to(card), t)
        for t in (cpu.params, cpu.opt_state, cpu.residuals))
    return cpu, gpu


def test_train_loss_and_grads_on_card_match_cpu(card):
    """f32 loss and gradients on the card against the same trainer on the
    CPU, at the CPU parity tests' tolerances (loss rtol 1e-5, each leaf
    within 1e-4 of its largest |entry|); no kernel launches."""
    from repro_torch.models.model import tree_flatten
    cpu, gpu = _train_pair(card)
    before = flash_forward.launches
    l_cpu, g_cpu = cpu._value_and_grad(cpu.batch_inputs(0)[0])
    l_gpu, g_gpu = gpu._value_and_grad(gpu.batch_inputs(0)[0])
    assert float(l_gpu) == pytest.approx(float(l_cpu), rel=1e-5)
    for a, b in zip(tree_flatten(g_cpu)[0], tree_flatten(g_gpu)[0]):
        assert b.is_cuda
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()) + 1e-12)
    assert flash_forward.launches == before


@pytest.mark.parametrize("opt_state, compress", [("f32", False),
                                                 ("int8", True)])
def test_train_step_on_card_is_bit_reproducible(card, opt_state, compress):
    """Two runs of one bf16 Trainer step from the same state give the same
    loss, grad norm, params, moments and residuals bit for bit."""
    from repro_torch.models.model import tree_flatten, tree_map
    _, gpu = _train_pair(card, torch.bfloat16, opt_state=opt_state,
                         compress_grads=compress)
    start = [tree_map(lambda t: t.clone(), t)
             for t in (gpu.params, gpu.opt_state, gpu.residuals)]
    first = gpu.train_step()
    after = tree_flatten(gpu.state_tree())[0]
    gpu.params, gpu.opt_state, gpu.residuals = start
    gpu.step = 0
    assert gpu.train_step() == first
    for a, b in zip(after, tree_flatten(gpu.state_tree())[0]):
        assert torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()
    assert torch.utils.deterministic.fill_uninitialized_memory


def test_cuda_backend_loss_fn_on_card_raises_under_autograd(card):
    """The card's flash kernel has no backward: ``loss_fn`` on
    ``backend="cuda"`` raises under autograd and launches nothing; without
    grad it runs the kernel."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.models.model import tree_flatten, tree_unflatten
    cfg = get_config("smollm_360m").reduced()
    model = Model(cfg, torch.float32, loss_chunk=16, remat=False)
    params = model.init_params(0)
    leaves, treedef = tree_flatten(params)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 32))
    before = flash_forward.launches
    with pytest.raises(RuntimeError, match='backend="torch"'):
        model.loss_fn(tree_unflatten(
            treedef, [p.detach().requires_grad_(True) for p in leaves]),
            tokens)
    assert flash_forward.launches == before
    with torch.no_grad():
        loss = model.loss_fn(params, tokens)
    assert bool(torch.isfinite(loss))
    assert flash_forward.launches == before + cfg.n_layers


@pytest.fixture
def nccl_mesh(card, tmp_path):
    """A one-rank NCCL group on the card (the rendezvous through a file in
    ``tmp_path``) and its (1, 1) mesh; torn down after."""
    import torch.distributed as dist
    from repro_torch.launch.cluster import initialize_from_env
    from repro_torch.launch.mesh import make_debug_mesh
    initialize_from_env(f"file://{tmp_path}/store", 1, 0, device=card,
                        timeout_s=120)
    try:
        assert dist.get_backend() == "nccl"
        yield make_debug_mesh(1, 1, device=card)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kw", [{}, {"compress_grads": True},
                                {"opt_state": "int8", "accum_steps": 2}],
                         ids=["f32", "compress", "int8-accum2"])
def test_dp_trainer_on_one_nccl_rank_is_bit_identical(nccl_mesh, kw):
    """The reduced smollm Trainer through a one-rank NCCL mesh against
    ``mesh=None`` on the card, bf16 compute, 3 steps: records, params,
    moments and residuals bit for bit; no kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import Trainer
    from repro_torch.models.model import tree_flatten
    cfg = get_config("smollm_360m").reduced()
    before = flash_forward.launches
    a = Trainer(cfg, batch=4, seq_len=32, **kw)
    b = Trainer(cfg, batch=4, seq_len=32, mesh=nccl_mesh, **kw)
    a.init_state(0)
    b.init_state(0)
    ra = [a.train_step() for _ in range(3)]
    rb = [b.train_step() for _ in range(3)]
    assert [(r["loss"], r["grad_norm"]) for r in ra] == \
        [(r["loss"], r["grad_norm"]) for r in rb]
    for x, y in zip(tree_flatten(a.state_tree())[0],
                    tree_flatten(b.state_tree())[0]):
        assert y.is_cuda and torch.equal(x, y)
    assert rb[-1]["replicas"] == 1 and rb[-1]["all_reduce_ms"] > 0
    assert flash_forward.launches == before


def test_compressed_psum_on_one_nccl_rank_matches_plain(nccl_mesh):
    from repro_torch.distributed.compression import (
        compressed_psum, compressed_psum_reference)
    gen = torch.Generator(device="cuda").manual_seed(0)
    g = torch.randn(300, 257, device="cuda", generator=gen)
    r = torch.randn(300, 257, device="cuda", generator=gen) * 0.01
    with nccl_mesh:
        out, res = compressed_psum(g, r, "data")
    want, want_res = compressed_psum_reference([g.cpu()], [r.cpu()])
    assert out.is_cuda and torch.equal(out.cpu(), want)
    assert torch.equal(res.cpu(), want_res[0])
