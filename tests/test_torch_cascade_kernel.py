"""The CUDA cascade kernel module (``repro_torch.kernels.cascade_kernel``)
against the reference's fused Pallas cascade kernel.

Here, without a card, ``cascade_qs_forward`` runs its plain torch version
on CPU tensors; ``ops.cuda_fused_cascade_qs(..., device="cpu")`` is held
against ``repro.kernels.ops.pallas_fused_cascade_qs(..., interpret=True)``
on the same forests, stages, gates and rows: scores and per-row exit
stages bit-exact on int-accum forests, exit stages identical and scores
within rtol 1e-5 / atol 1e-6 on float forests (the same f32 leaves summed
in another order).  The gate's device form (``GatePolicy.kernel_gate``),
which only the kernel on the card reads, is checked here by replaying the
kernel's gate arithmetic in numpy from it.  ``test_torch_cuda.py`` holds
the kernel itself against its plain version on the card.
"""
import copy
import dataclasses
import inspect

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import cascade as rc  # noqa: E402
from repro import core as rcore  # noqa: E402
from repro.kernels.ops import pallas_fused_cascade_qs  # noqa: E402
from repro_torch import cascade as tc  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.cascade import policy as tpolicy  # noqa: E402
from repro_torch.kernels import cascade_kernel as ck  # noqa: E402
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

INT16 = rcore.QuantSpec(16, int_accum=True)
# (n_trees, n_leaves, n_features, n_classes, stages, gate name, batch,
# vote leaves): a margin gate through the softmax of logit leaves, a
# two-word (L=64) vote forest, the bound gate where its later stages are
# short enough to fire, the C = 1 decision band
CASES = [
    (24, 16, 8, 3, (6, 12, 24), "margin0.3", 70, False),
    (16, 64, 8, 2, (4, 16), "proba0.6", 64, True),
    (24, 16, 8, 3, (20, 22, 24), "bound", 96, True),
    (24, 16, 8, 1, (20, 22, 24), "bound_band", 40, False),
]
GATES = {
    "margin0.3": (rc.MarginGate(0.3), tc.MarginGate(0.3)),
    "proba0.6": (rc.ProbaGate(0.6), tc.ProbaGate(0.6)),
    "bound": (rc.ScoreBoundGate(), tc.ScoreBoundGate()),
    "bound_band": (rc.ScoreBoundGate(0.5, 0.25),
                   tc.ScoreBoundGate(0.5, 0.25)),
    "never": (rc.MarginGate(np.inf), tc.MarginGate(np.inf)),
}


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


def _forest(T, L, d, C, B, quantized, votes=False):
    f = rcore.random_forest_ir(T, L, d, n_classes=C, seed=T + L,
                               full=False)
    if votes:
        f = dataclasses.replace(f, leaf_value=np.abs(f.leaf_value))
    X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
    return (rcore.quantize_forest(f, X, INT16) if quantized else f), X


def _both(forest, X, stages, gate, n_valid):
    """(port plain version, reference Pallas interpret) of the fused
    cascade on the same rows: each (descaled scores, exit stage (B,))."""
    rg, tg = (copy.copy(g) for g in GATES[gate])
    rg.prepare(forest, stages)
    tf = port(forest)
    tg.prepare(tf, stages)
    Xq = rcore.quantize_inputs(forest, X).astype(np.float32)
    B = len(X)
    Bp = -(-B // 32) * 32
    Xp = np.zeros((Bp, X.shape[1]), dtype=np.float32)
    Xp[:B] = Xq
    valid = np.arange(Bp) < n_valid
    fn = ops.cuda_fused_cascade_qs(tf, stages, tg, block_t=4, device="cpu")
    before = ck.cascade_qs_forward.launches
    s, e = fn(torch.from_numpy(Xp), torch.from_numpy(valid))
    assert ck.cascade_qs_forward.launches == before    # plain version
    ref = pallas_fused_cascade_qs(forest, stages, rg, block_b=32, block_t=4,
                                  interpret=True)
    rs, re = ref(Xp, valid)
    return (s.numpy(), e.numpy()), (np.asarray(rs), np.asarray(re)[:, 0])


@pytest.mark.parametrize("T,L,d,C,stages,gate,B,votes", CASES)
def test_plain_version_matches_pallas_int_accum(T, L, d, C, stages, gate,
                                                B, votes):
    forest, X = _forest(T, L, d, C, B, quantized=True, votes=votes)
    (s, e), (rs, re) = _both(forest, X, stages, gate, n_valid=B - 5)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(e, re)
    counts = np.bincount(e[:B - 5], minlength=len(stages))
    assert counts[:-1].sum() > 0, f"the gate never fired: {counts}"
    # padded and invalid rows: zero scores, the default exit stage
    assert not s[B - 5:].any() and (e[B - 5:] == len(stages) - 1).all()


@pytest.mark.parametrize("T,L,d,C,stages,gate,B,votes", CASES[:3])
def test_plain_version_matches_pallas_float(T, L, d, C, stages, gate, B,
                                            votes):
    """Float forests: the gate on f32 scores summed in another order; the
    exit stages agree, the scores within tolerance."""
    forest, X = _forest(T, L, d, C, B, quantized=False, votes=votes)
    (s, e), (rs, re) = _both(forest, X, stages, gate, n_valid=B)
    np.testing.assert_array_equal(e, re)
    np.testing.assert_allclose(s, rs, rtol=1e-5, atol=1e-6)


def test_gate_never_fires_is_qs_forward():
    """A disabled gate runs every stage: the plain bitvector kernel's
    function on the whole forest."""
    forest, X = _forest(24, 16, 8, 3, 64, quantized=True)
    (s, e), _ = _both(forest, X, (6, 12, 24), "never", n_valid=64)
    want = ops.cuda_qs_predictor(port(forest), block_t=4,
                                 device="cpu").predict(X)
    np.testing.assert_array_equal(s[:64], want)
    assert (e == 2).all()


# --------------------------------------------------------------------------- #
# the gate's device form
# --------------------------------------------------------------------------- #
def _device_gate(gate, scores, stage, n_stages):
    """The kernel's gate arithmetic (cascade_qs_forward.cu) in numpy f32,
    reading only the device form ``gate``."""
    c = gate.consts
    s = scores.astype(np.float32)
    C = s.shape[1]
    if gate.kind == tpolicy.GATE_NEVER:
        return np.zeros(len(s), dtype=bool)
    if gate.kind == tpolicy.GATE_SCORE_BOUND:
        g = n_stages - 1
        rmin = c[5:5 + g * C].reshape(g, C)[stage]
        rmax = c[5 + g * C:].reshape(g, C)[stage]
        lo, hi = s + rmin, s + rmax
        if C == 1:
            return (lo[:, 0] > c[2]) | (hi[:, 0] < c[3])
        best = s.argmax(axis=1)
        rows = np.arange(len(s))
        other = hi.copy()
        other[rows, best] = -np.inf
        return lo[rows, best] > other.max(axis=1) - c[4]
    if gate.votes:
        v = np.maximum(s, np.float32(0))
        tot = np.zeros(len(s), dtype=np.float32)
        for k in range(C):
            tot = tot + v[:, k]
        p = np.where(tot[:, None] > 0,
                     v / np.where(tot > 0, tot, 1)[:, None], c[1])
    else:
        e = np.exp(s - s.max(axis=1, keepdims=True))
        tot = np.zeros(len(s), dtype=np.float32)
        for k in range(C):
            tot = tot + e[:, k]
        p = e / tot[:, None]
    top = p.max(axis=1)
    if gate.kind == tpolicy.GATE_PROBA:
        return top >= c[0]
    other = p.copy()
    other[np.arange(len(p)), p.argmax(axis=1)] = -np.inf
    return top - other.max(axis=1) >= c[0]


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("C,votes", [(3, True), (3, False), (1, False)])
def test_device_form_replays_decide(gate, C, votes):
    forest, X = _forest(24, 16, 8, C, 200, quantized=True, votes=votes)
    stages = (6, 12, 24) if gate != "bound" else (20, 22, 24)
    tf = port(forest)
    pol = copy.copy(GATES[gate][1])
    pol.prepare(tf, stages)
    casc = tc.CascadePredictor(tf, tc.CascadeSpec(stages, pol),
                               device="cpu")
    cum = casc.cumulative_scores(X)
    dev = pol.kernel_gate(len(stages))
    assert dev.consts.dtype == np.float32
    for k in range(len(stages) - 1):
        want = pol.decide(torch.from_numpy(cum[k]), k).numpy()
        np.testing.assert_array_equal(_device_gate(dev, cum[k], k,
                                                   len(stages)), want)


def test_device_form_constants():
    forest, _ = _forest(24, 16, 8, 3, 8, quantized=True)
    tf = port(forest)
    stages = (6, 12, 24)
    g = tc.MarginGate(0.3)
    g.prepare(tf, stages)
    dev = g.kernel_gate(3)
    assert dev.kind == tpolicy.GATE_MARGIN and not dev.votes
    assert dev.consts[0] == np.float32(0.3)
    assert dev.consts[1] == np.float32(1.0 / 3)
    assert dev.consts.shape == (5,)
    for never in (tc.MarginGate(np.inf), tc.ProbaGate(np.inf)):
        never.prepare(tf, stages)
        assert never.kernel_gate(3).kind == tpolicy.GATE_NEVER
    p = tc.ProbaGate(0.6)
    p.prepare(tf, stages)
    assert p.kernel_gate(3).kind == tpolicy.GATE_PROBA
    b = tc.ScoreBoundGate(0.5, 0.25)
    b.prepare(tf, stages)
    dev = b.kernel_gate(3)
    assert dev.kind == tpolicy.GATE_SCORE_BOUND
    np.testing.assert_array_equal(dev.consts[2:5], np.float32(
        [0.25 - 0.5, 0.25 + 0.5, 0.5]))
    np.testing.assert_array_equal(dev.consts[5:11].reshape(2, 3),
                                  b._rest_min[:2])
    np.testing.assert_array_equal(dev.consts[11:].reshape(2, 3),
                                  b._rest_max[:2])
    # inv_scale first, made once per device
    ops_t = dev.operands(0.25, "cpu")
    assert ops_t[0].item() == 0.25 and dev.operands(0.25, "cpu") is ops_t
    np.testing.assert_array_equal(ops_t[1:].numpy(), dev.consts)


class _NumpyOnlyGate(tc.GatePolicy):
    """A third-party policy with only a numpy ``exits``."""

    def exits(self, scores, stage):
        return scores[:, 0] > 0

    def tag(self):
        return "numpy-only"


def test_third_party_policy_has_no_device_form():
    forest, X = _forest(24, 16, 8, 3, 16, quantized=True)
    tf = port(forest)
    with pytest.raises(NotImplementedError, match="fused=False"):
        _NumpyOnlyGate().kernel_gate(2)
    with pytest.raises(NotImplementedError, match="_NumpyOnlyGate"):
        tc.FusedCascadePredictor(
            tf, tc.CascadeSpec((12, 24), _NumpyOnlyGate(), fused=True),
            backend="cuda", device="cpu")
    # the staged loop takes it
    staged = tc.CascadePredictor(tf, tc.CascadeSpec((12, 24),
                                                    _NumpyOnlyGate()),
                                 backend="cuda", device="cpu")
    assert staged.predict(X).shape == (16, 3)
    assert staged.last_exit_counts.sum() == 16


# --------------------------------------------------------------------------- #
# the wrapper's checks and host glue
# --------------------------------------------------------------------------- #
def _operands(B=10):
    forest, X = _forest(24, 16, 8, 3, B, quantized=True)
    tf = port(forest)
    pol = tc.MarginGate(0.3)
    pol.prepare(tf, (6, 24))
    fn = ops.cuda_fused_cascade_qs(tf, (6, 24), pol, block_t=8,
                                   device="cpu")
    x = torch.from_numpy(rcore.quantize_inputs(forest, X).astype(np.float32))
    kw = dict(stage_bounds=fn.stage_bounds, policy=pol, inv_scale=1.0,
              out_dtype=fn.out_dtype)
    return x, torch.ones(B, dtype=torch.bool), fn.arrays, kw


def test_wrapper_rejects_bad_operands():
    x, valid, arrays, kw = _operands()
    with pytest.raises(TypeError, match="valid"):
        ck.cascade_qs_forward(x, valid.int(), *arrays, **kw)
    with pytest.raises(ValueError, match="inconsistent"):
        ck.cascade_qs_forward(x, valid[:-1], *arrays, **kw)
    with pytest.raises(ValueError, match="stage_bounds"):
        ck.cascade_qs_forward(x, valid, *arrays,
                              **dict(kw, stage_bounds=(0, 8, 16)))
    with pytest.raises(ValueError, match="stage_bounds"):
        ck.cascade_qs_forward(x, valid, *arrays,
                              **dict(kw, stage_bounds=(0, 16, 8, 32)))
    with pytest.raises(TypeError, match="out_dtype"):
        ck.cascade_qs_forward(x, valid, *arrays,
                              **dict(kw, out_dtype=torch.int64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ck.cascade_qs_forward(*(t.to("meta") for t in (x, valid) + arrays),
                              **kw)
    scores, exit_stage = ck.cascade_qs_forward(x, valid, *arrays, **kw)
    assert scores.dtype == torch.int32 and exit_stage.dtype == torch.int32


def test_fused_cascade_glue():
    forest, _ = _forest(24, 16, 8, 3, 8, quantized=True)
    tf = port(forest)
    pol = tc.MarginGate(0.3)
    pol.prepare(tf, (6, 12, 24))
    fn = ops.cuda_fused_cascade_qs(tf, (6, 12, 24), pol, block_t=8,
                                   device="cpu")
    # stages padded to block_t on their own: 6 → 8, 6 → 8, 12 → 16
    assert fn.stage_bounds == (0, 8, 16, 32)
    assert fn.out_dtype == torch.int32
    flint = tcore.flint_forest(port(_forest(8, 16, 4, 1, 4, False)[0]))
    with pytest.raises(ValueError, match="FLInt"):
        ops.cuda_fused_cascade_qs(flint, (4, 8), pol, device="cpu")


# (d, N, W, C) → (route, chunk, cluster, shared bytes).  Shared bytes: the
# ring 2·chunk·4·⌈N⌉₈·words(W) (nodes rounded up to 8; 4 words a record at
# W <= 2, 12 at W = 8); the
# sums 4·⌈(11·32·C + 65) / 4⌉·4; the x tile 4·33·d on the smem_x route.
# The cluster: the largest power of two <= 8 whose blocks for 1024 rows
# (32 tiles) fit one wave of the 132 SMs at the blocks an SM holds.
LAYOUTS = [
    # the mnist cascade: 32,768 + 14,352 + 103,488; one block an SM, so
    # 4 x 32 = 128 blocks by the estimate (the card holds 30 clusters of 4
    # but 39 of 3: test_cascade_layout_asks_the_card)
    (784, 63, 2, 10, ("smem_x", 16, 4, 150608)),
    # narrow rows: 8,192 + 4,496 + 1,056; eight blocks an SM
    (8, 15, 1, 3, ("smem_x", 16, 8, 13744)),
    # the kernel's limits: 196,608 (8 trees of 12,288 bytes) + 22,800 +
    # 924
    (7, 255, 8, 16, ("smem_x", 8, 4, 220332)),
    # one class: 32,768 + 1,680 + 17,952; four blocks an SM
    (136, 63, 2, 1, ("smem_x", 16, 8, 52400)),
    # rows too wide for a 32-row x tile: x from global memory
    (2000, 63, 2, 10, ("global_x", 16, 8, 47120)),
]


@pytest.mark.parametrize("d,N,W,C,want", LAYOUTS)
def test_cascade_layout(d, N, W, C, want):
    lay = ck.cascade_layout(d, N, W, C)
    assert (lay.route, lay.chunk, lay.cluster, lay.shared_bytes) == want
    assert lay.shared_bytes == ck.cascade_shared_bytes(
        N, W, C, d, lay.chunk, lay.route == "smem_x")
    assert lay.shared_bytes <= launch.MAX_SHARED_BYTES
    assert 1024 // launch.TILE_ROWS * lay.cluster \
        <= lay.blocks_per_sm * launch.H100_SMS


def test_cascade_layout_asks_the_card():
    """On the card the wrapper counts resident clusters with
    cudaOccupancyMaxActiveClusters.  An H100 80GB HBM3 at the mnist shape
    (one block an SM) holds 132 clusters of 1, 66 of 2, 39 of 3, 30 of 4,
    22 of 5, 17 of 6 and 15 of 7 or 8 (scripts/torch_forest_tiles.py's
    layout line): 32 tiles of 4 would take two waves, so the cluster is 3.
    A card that holds none raises."""
    held = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
    asked = []

    def resident(lay):
        asked.append(lay.cluster)
        return held[lay.cluster]
    lay = ck.cascade_layout(784, 63, 2, 10, resident=resident)
    assert lay.cluster == 3 and asked[:6] == [8, 7, 6, 5, 4, 3]
    assert lay == dataclasses.replace(ck.cascade_layout(784, 63, 2, 10),
                                      cluster=3)
    # fewer than 32 clusters of any size: one block a tile, several waves
    assert ck.cascade_layout(784, 63, 2, 10,
                             resident=lambda lay: 16 // lay.cluster
                             ).cluster == 1
    with pytest.raises(RuntimeError, match="no cluster"):
        ck.cascade_layout(784, 63, 2, 10, resident=lambda lay: 0)


def test_cascade_layout_never_depends_on_the_batch():
    """The layout takes no batch size: a row's trees are split over the
    cluster, and summed in one order, alike in every batch."""
    assert list(inspect.signature(ck.cascade_layout).parameters) == \
        ["d", "N", "W", "C", "n_sm", "resident"]
    # the route changes where 32 rows of x stop fitting, whatever B is
    widest = max(d for d in range(1500, 1800)
                 if ck.cascade_layout(d, 63, 2, 10).route == "smem_x")
    assert ck.cascade_layout(widest + 1, 63, 2, 10).route == "global_x"
    with pytest.raises(ValueError, match="shared memory"):
        ck.cascade_layout(8, 4000, 8, 16)


def test_kernel_tier_on_cpu_uses_the_plain_version():
    forest, X = _forest(24, 16, 8, 3, 40, quantized=True, votes=True)
    tf = port(forest)
    pred = tcore.compile_forest(tf, engine="bitvector", backend="cuda",
                                device="cpu", cascade=tc.CascadeSpec(
                                    (6, 12, 24), tc.MarginGate(0.3),
                                    fused=True))
    assert pred._use_kernel and pred.host_syncs == 1
    before = ck.cascade_qs_forward.launches
    staged = tc.CascadePredictor(tf, tc.CascadeSpec((6, 12, 24),
                                                    tc.MarginGate(0.3)),
                                 device="cpu")
    np.testing.assert_array_equal(pred.predict(X), staged.predict(X))
    np.testing.assert_array_equal(pred.last_exit_counts,
                                  staged.last_exit_counts)
    assert ck.cascade_qs_forward.launches == before
