"""The CUDA bit-matmul and GEMM kernel modules against the reference Pallas
kernels.

Here, without a card, ``cuda_bitmm_predictor`` and ``cuda_gemm_predictor``
with ``device="cpu"`` run their kernels' plain torch versions through the
same host glue (padding, bucketing, int accumulation, descale); they are
held against ``repro.kernels.ops.pallas_bitmm_predictor`` and
``pallas_gemm_predictor`` in interpret mode, as tests/test_kernels.py and
tests/test_bitmm.py run them.  Float forests rtol 1e-5 / atol 1e-6 against
the reference and 1e-4 / 1e-5 against the numpy oracle; int-accum forests
bit-exact.  ``test_torch_cuda.py`` holds the kernels themselves against
their plain versions on the card."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as rcore  # noqa: E402
from repro.kernels.ops import (pallas_bitmm_predictor,  # noqa: E402
                               pallas_gemm_predictor)
from repro.kernels.ref import ref_gemm as rref_gemm  # noqa: E402
from repro.kernels.ref import ref_oracle  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.kernels import gemm_forest_kernel as gk  # noqa: E402
from repro_torch.kernels import launch  # noqa: E402
from repro_torch.kernels import ops, quickscorer_kernel as qk  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.gemm_forest_kernel import (  # noqa: E402
    gemm_forward, gemm_forward_reference)
from repro_torch.kernels.quickscorer_kernel import (  # noqa: E402
    qs_bitmm_forward, qs_bitmm_forward_reference)
from test_bitmm import FOREST_SWEEP  # noqa: E402
from test_kernels import SHAPE_SWEEP  # noqa: E402

KERNELS = {
    "bitmm": (ops.cuda_bitmm_predictor, pallas_bitmm_predictor),
    "gemm": (ops.cuda_gemm_predictor, pallas_gemm_predictor),
}
INT16 = rcore.QuantSpec(16, int_accum=True)


def port(ref_forest):
    return tcore.forest_from_reference(vars(ref_forest))


def rows(B, d, seed):
    return np.random.default_rng(seed).normal(0, 1.3, size=(B, d))


def both(kernel, forest, X, **blocks):
    """(port on the CPU, reference Pallas in interpret mode) predictions."""
    cuda_pred, pallas_pred = KERNELS[kernel]
    got = cuda_pred(port(forest), device="cpu", **blocks).predict(X)
    return got, pallas_pred(forest, **blocks).predict(X)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("T,L,d,C,B", SHAPE_SWEEP[:4])
def test_cuda_kernel_matches_pallas_shape_sweep(kernel, T, L, d, C, B):
    forest = rcore.random_forest_ir(T, L, d, n_classes=C, seed=T,
                                    full=(T % 2 == 0))
    X = rows(B, d, B)
    got, want = both(kernel, forest, X, block_b=32, block_t=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref_oracle(forest, X), rtol=1e-4,
                               atol=1e-5)
    got, want = both(kernel, rcore.quantize_forest(forest, X, INT16), X,
                     block_b=32, block_t=4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("T,L,d,C,full,seed", FOREST_SWEEP)
def test_cuda_kernel_matches_pallas_forest_sweep(kernel, T, L, d, C, full,
                                                 seed):
    """Deep unbalanced trees (wide count fields, 22 packed groups at
    L=128), stumps and multiclass forests, with small blocks."""
    forest = rcore.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                    full=full)
    X = rows(24, d, seed + 200)
    got, want = both(kernel, forest, X, block_b=16, block_t=4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref_oracle(forest, X), rtol=1e-4,
                               atol=1e-5)
    got, want = both(kernel, rcore.quantize_forest(forest, X, INT16), X,
                     block_b=16, block_t=4)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("bits", [16, 8])
def test_cuda_kernel_quantized_trained(kernel, bits, trained_rf, magic_ds):
    qf = rcore.quantize_forest(rcore.from_random_forest(trained_rf),
                               magic_ds.X_train,
                               rcore.QuantSpec(bits, int_accum=True))
    X = magic_ds.X_test[:64]
    got, want = both(kernel, qf, X, block_b=32, block_t=8)
    np.testing.assert_array_equal(got, want)
    assert KERNELS[kernel][0](port(qf), device="cpu").out_dtype == \
        torch.int32


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_block_shape_independence(kernel, small_forest):
    """The result must not depend on the row bucket or tree padding."""
    X = rows(70, small_forest.n_features, 7)
    cuda_pred = KERNELS[kernel][0]
    outs = [cuda_pred(port(small_forest), block_b=bb, block_t=bt,
                      device="cpu").predict(X)
            for bb, bt in [(8, 2), (32, 4), (128, 8)]]
    for got in outs:
        np.testing.assert_allclose(got, ref_oracle(small_forest, X),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(got, outs[0])


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_padding_batch_edge(kernel, small_forest):
    """Batch not a multiple of block_b: padded rows must not leak."""
    X = rows(5, small_forest.n_features, 8)
    got, want = both(kernel, small_forest, X, block_b=64)
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bitmm_arrays_padding(class_forest):
    """12 trees padded to 16: +inf thresholds, zero packed rows, a full
    bias word and zero leaf rows; packed words travel as exact int32."""
    forest = port(class_forest)
    (feat, thr, packed, bias, leaf_val), bits, npack = \
        ops._bitmm_arrays(forest, 8)
    want_packed, want_bias, _, _ = tcore.quickscorer.bitmm_pack_arrays(forest)
    assert packed.dtype == bias.dtype == np.int32
    np.testing.assert_array_equal(packed[:12], want_packed)
    np.testing.assert_array_equal(bias[:12], want_bias)
    assert feat.shape[0] == 16 and np.isinf(thr[12:]).all()
    assert (packed[12:] == 0).all() and (leaf_val[12:] == 0).all()
    full = tcore.quickscorer.bitmm_full_word(bits, npack)
    assert (bias[12:] == full).all()
    assert np.isposinf(thr[:12][forest.feature < 0]).all()


def test_gemm_arrays_padding(class_forest):
    """12 trees padded to 16: -inf thresholds for padding nodes and trees,
    no mask bits for padding trees, Bvec = L + 1 for padding trees and
    leaves; the masks are A's +1 and -1 nodes."""
    forest = port(class_forest)
    feat, thr, plus, minus, Bvec, leaf_val = ops._gemm_arrays(forest, 8)
    assert plus.dtype == minus.dtype == Bvec.dtype == np.int32
    A = gk.node_matrix(torch.from_numpy(plus), torch.from_numpy(minus),
                       feat.shape[1]).numpy()
    np.testing.assert_array_equal(A[:12], tcore.baselines.gemm_arrays(
        forest)[0])
    assert not (plus & minus).any()
    L = forest.n_leaves
    assert np.isneginf(thr[12:]).all() and (A[12:] == 0).all()
    assert (Bvec[12:] == L + 1).all() and (leaf_val[12:] == 0).all()
    assert np.isneginf(thr[:12][forest.feature < 0]).all()
    for t in range(12):
        assert (Bvec[t, forest.n_leaves_per_tree[t]:] == L + 1).all()


@pytest.mark.parametrize("N", [1, 31, 32, 63, 100, 255, 300])
def test_node_masks_round_trip(N):
    """Bit j of word k is node 32k + j, for every word width."""
    A = np.random.default_rng(N).integers(-1, 2, size=(3, N, 5)).astype(
        np.float32)
    plus, minus = gk.node_masks(A)
    assert plus.shape == (3, 5, gk.fire_words(N)) and plus.dtype == np.int32
    got = gk.node_matrix(torch.from_numpy(plus), torch.from_numpy(minus), N)
    np.testing.assert_array_equal(got.numpy(), A)
    words = plus.view(np.uint32)
    n = N - 1
    assert bool(words[0, 0, n // 32] >> np.uint32(n % 32) & 1) == \
        (A[0, n, 0] > 0)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int32])
def test_gemm_plain_version_sums_every_hit(out_dtype):
    """Two leaves matching one row both count, as in the kernel; the
    engine's integer path takes the first hit only."""
    x = torch.zeros((3, 2))
    feat = torch.zeros((1, 1), dtype=torch.int32)
    thr = torch.full((1, 1), -float("inf"))
    plus = torch.zeros((1, 4, 1), dtype=torch.int32)
    Bvec = torch.tensor([[0, 0, 5, 5]], dtype=torch.int32)
    leaf_val = torch.tensor([[[1.0], [2.0], [4.0], [8.0]]])
    got = gemm_forward(x, feat, thr, plus, plus.clone(), Bvec, leaf_val,
                       out_dtype=out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy(), np.full((3, 1), 3))
    first = tcore.baselines.gemm_scores(x, feat, thr, torch.zeros((1, 1, 4)),
                                        Bvec, leaf_val.int(), torch.int32)
    np.testing.assert_array_equal(first.numpy(), np.full((3, 1), 1))


def test_ref_oracles_match_reference(class_forest):
    X = rows(40, class_forest.n_features, 9)
    np.testing.assert_allclose(tref.ref_gemm(port(class_forest), X),
                               rref_gemm(class_forest, X), rtol=1e-5,
                               atol=1e-6)
    want = rcore.compile_forest(class_forest, engine="bitmm").predict(X)
    np.testing.assert_allclose(tref.ref_bitmm(port(class_forest), X), want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tref.ref_bitmm(port(class_forest), X),
                               tref.ref_oracle(port(class_forest), X),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_out_dtype_rejects_what_the_reference_rejects(kernel, small_forest):
    qf = port(rcore.quantize_forest(small_forest, None, INT16))
    big = qf.leaf_value.copy()
    big[0, 0, 0] = 2 ** 22
    qf.leaf_value = big
    with pytest.raises(ValueError, match="2\\^24"):
        KERNELS[kernel][0](qf, block_t=8, device="cpu")


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_flint_forest_rejected(kernel, small_forest):
    forest = tcore.flint_forest(port(small_forest))
    with pytest.raises(ValueError, match="FLInt"):
        KERNELS[kernel][0](forest, device="cpu")


# --------------------------------------------------------------------------- #
# the wrappers: plain version on the CPU, checks, limits
# --------------------------------------------------------------------------- #
def _bitmm_args(forest, B=9, seed=0):
    arrays, bits, npack = ops._bitmm_arrays(forest, 4)
    X = rows(B, forest.n_features, seed).astype(np.float32)
    return ([torch.from_numpy(X)] + [torch.from_numpy(a) for a in arrays],
            dict(bits=bits, npack=npack, n_leaves=forest.n_leaves))


def _gemm_args(forest, B=9, seed=0):
    X = rows(B, forest.n_features, seed).astype(np.float32)
    return [torch.from_numpy(X)] + [torch.from_numpy(a)
                                    for a in ops._gemm_arrays(forest, 4)]


def test_cpu_tensors_run_the_plain_versions_uncounted(class_forest):
    forest = port(class_forest)
    args, kw = _bitmm_args(forest)
    before = qs_bitmm_forward.launches
    np.testing.assert_array_equal(
        qs_bitmm_forward(*args, **kw).numpy(),
        qs_bitmm_forward_reference(*args, **kw).numpy())
    assert qs_bitmm_forward.launches == before
    args = _gemm_args(forest)
    before = gemm_forward.launches
    np.testing.assert_array_equal(gemm_forward(*args).numpy(),
                                  gemm_forward_reference(*args).numpy())
    assert gemm_forward.launches == before


def test_plain_versions_sum_raw_leaves(class_forest):
    """Raw sums (B, C) before the descale, int32 for int accumulation."""
    X = rows(9, class_forest.n_features, 0)
    qf = port(rcore.quantize_forest(class_forest, X, INT16))
    args, kw = _bitmm_args(qf)
    args[0] = torch.from_numpy(tcore.quantize_inputs(qf, X).astype(
        np.float32))
    raw = qs_bitmm_forward(*args, out_dtype=torch.int32, **kw)
    assert raw.dtype == torch.int32 and raw.shape == (9, 3)
    want = qf.predict_oracle(tcore.quantize_inputs(qf, X))
    np.testing.assert_array_equal(raw.numpy(), want)
    gargs = [args[0]] + _gemm_args(qf)[1:]
    np.testing.assert_array_equal(
        gemm_forward(*gargs, out_dtype=torch.int32).numpy(), want)


def test_bitmm_forward_checks_its_inputs(small_forest):
    args, kw = _bitmm_args(port(small_forest))
    bad = list(args)
    bad[3] = args[3].float()
    with pytest.raises(TypeError, match="packed: dtype"):
        qs_bitmm_forward(*bad, **kw)
    bad = list(args)
    bad[4] = args[4][:, :-1].contiguous()
    with pytest.raises(ValueError, match="inconsistent shapes"):
        qs_bitmm_forward(*bad, **kw)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        qs_bitmm_forward(*bad, **kw)
    with pytest.raises(ValueError, match="24 bits"):
        qs_bitmm_forward(*args, **{**kw, "bits": 5, "npack": 5})
    with pytest.raises(ValueError, match="n_leaves"):
        qs_bitmm_forward(*args, **{**kw, "n_leaves": 1000})
    with pytest.raises(TypeError, match="out_dtype"):
        qs_bitmm_forward(*args, out_dtype=torch.float64, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        qs_bitmm_forward(*[a.to("meta") for a in args], **kw)


def test_gemm_forward_checks_its_inputs(small_forest):
    args = _gemm_args(port(small_forest))
    bad = list(args)
    bad[3] = args[3].float()
    with pytest.raises(TypeError, match="plus: dtype"):
        gemm_forward(*bad)
    for i in (4, 5):
        bad = list(args)
        bad[i] = args[i][:, :-1].contiguous()
        with pytest.raises(ValueError, match="inconsistent shapes"):
            gemm_forward(*bad)
    bad = list(args)
    bad[1] = args[1].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        gemm_forward(*bad)
    with pytest.raises(TypeError, match="out_dtype"):
        gemm_forward(*args, out_dtype=torch.int16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        gemm_forward(*[a.to("meta") for a in args])


def test_predictor_takes_the_launch_function(small_forest):
    """``_KernelPredictor`` launches whatever wrapper it is given."""
    calls = []

    def fake(x, *arrays, out_dtype):
        calls.append((x.shape, len(arrays), out_dtype))
        return torch.zeros((x.shape[0], 1), dtype=out_dtype)

    forest = port(small_forest)
    pred = ops._KernelPredictor(forest, fake, ops._gemm_arrays(forest, 8),
                                torch.float32, 16, torch.device("cpu"))
    out = pred.predict(rows(3, forest.n_features, 0))
    assert out.shape == (3, 1) and calls == [((16, 6), 6, torch.float32)]
    with pytest.raises(ValueError, match="width"):
        pred.predict_transformed(np.zeros((3, 1), dtype=np.float32))


def test_tree_chunks_fit_shared_memory():
    for T, N, G in [(1024, 63, 8), (4, 127, 22), (5, 255, 43), (3, 0, 1)]:
        tc = qk.tree_chunk(T, N, G)
        assert 1 <= tc <= min(max(T, 1), launch.MAX_TREE_CHUNK)
        assert tc == 1 or 4 * tc * (N * (2 + G) + G) <= launch.SHARED_BYTES
    # one tree of the widest packing (N=255, bits 8, 86 groups) needs
    # more than 48 KB, and opts into at most 227 KB
    assert 4 * (255 * (2 + 86) + 86) <= launch.MAX_SHARED_BYTES
    for T, N, L in [(1024, 63, 64), (5, 255, 256), (3, 1, 2)]:
        tc = gk.gemm_tree_chunk(T, N, L)
        fw = gk.fire_words(N)
        assert 32 * fw >= N and fw in (1, 2, 4, 8)
        assert 4 * tc * (2 * N + L * (2 * fw + 1)) <= launch.SHARED_BYTES
    assert [gk.fire_words(n) for n in (0, 32, 33, 64, 65, 129, 256)] == \
        [1, 1, 2, 2, 4, 8, 8]
