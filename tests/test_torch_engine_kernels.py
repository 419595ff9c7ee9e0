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
import dataclasses

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
    bias word and zero leaf rows; packed words travel exactly as u8 byte
    planes (T, 3, G, Npad) and the bias as int32."""
    forest = port(class_forest)
    (feat, thr, planes, bias, leaf_val), bits, npack = \
        ops._bitmm_arrays(forest, 8)
    want_packed, want_bias, _, _ = tcore.quickscorer.bitmm_pack_arrays(forest)
    N, G = want_packed.shape[1:]
    assert planes.dtype == np.uint8 and bias.dtype == np.int32
    assert planes.shape == (16, 3, G, launch.node_pad(N))
    packed = qk.packed_words(torch.from_numpy(planes), N).numpy()
    np.testing.assert_array_equal(packed[:12], want_packed)
    np.testing.assert_array_equal(bias[:12], want_bias)
    assert feat.shape[0] == 16 and np.isinf(thr[12:]).all()
    assert (planes[12:] == 0).all() and (leaf_val[12:] == 0).all()
    assert not planes[..., N:].any()
    full = tcore.quickscorer.bitmm_full_word(bits, npack)
    assert (bias[12:] == full).all()
    assert np.isposinf(thr[:12][forest.feature < 0]).all()


def test_gemm_arrays_padding(class_forest):
    """12 trees padded to 16: -inf thresholds for padding nodes and trees,
    zero A for padding trees, Bvec = L + 1 for padding trees and leaves; A
    travels as int8 (T, L, Npad), leaf-major and K-major per tree."""
    forest = port(class_forest)
    feat, thr, A8, Bvec, leaf_val = ops._gemm_arrays(forest, 8)
    N = feat.shape[1]
    assert A8.dtype == np.int8 and Bvec.dtype == np.int32
    assert A8.shape == (16, forest.n_leaves, launch.node_pad(N))
    A = gk.node_matrix(torch.from_numpy(A8), N).numpy()
    np.testing.assert_array_equal(A[:12], tcore.baselines.gemm_arrays(
        forest)[0])
    assert not A8[..., N:].any()
    L = forest.n_leaves
    assert np.isneginf(thr[12:]).all() and (A[12:] == 0).all()
    assert (Bvec[12:] == L + 1).all() and (leaf_val[12:] == 0).all()
    assert np.isneginf(thr[:12][forest.feature < 0]).all()
    for t in range(12):
        assert (Bvec[t, forest.n_leaves_per_tree[t]:] == L + 1).all()


@pytest.mark.parametrize("N", [1, 31, 32, 63, 100, 255, 300])
def test_leaf_major_round_trip(N):
    """A[t, n, l] lands at [t, l, n] of the int8 operand, nodes padded to
    whole k-steps of 32 with zeros, for every node count."""
    A = np.random.default_rng(N).integers(-1, 2, size=(3, N, 5)).astype(
        np.float32)
    A8 = gk.leaf_major(A)
    assert A8.shape == (3, 5, launch.node_pad(N)) and A8.dtype == np.int8
    assert A8.shape[-1] % 32 == 0 and not A8[..., N:].any()
    got = gk.node_matrix(torch.from_numpy(A8), N)
    np.testing.assert_array_equal(got.numpy(), A)
    assert A8[1, 4, N - 1] == A[1, N - 1, 4]


@pytest.mark.parametrize("N,G", [(1, 1), (31, 3), (63, 8), (127, 22),
                                 (255, 86)])
def test_byte_planes_round_trip(N, G):
    """Words below 2^24 split into three u8 planes, byte p of [t, n, g] at
    [t, p, g, n], and join again exactly; wider words are refused."""
    w = np.random.default_rng(N).integers(0, 1 << 24, size=(2, N, G))
    planes = qk.byte_planes(w)
    assert planes.shape == (2, 3, G, launch.node_pad(N))
    assert planes.dtype == np.uint8 and not planes[..., N:].any()
    assert planes[1, 2, G - 1, N - 1] == w[1, N - 1, G - 1] >> 16
    got = qk.packed_words(torch.from_numpy(planes), N)
    np.testing.assert_array_equal(got.numpy(), w)
    with pytest.raises(ValueError, match="2\\^24"):
        qk.byte_planes(w + (1 << 24))


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.int32])
def test_gemm_plain_version_sums_every_hit(out_dtype):
    """Two leaves matching one row both count, as in the kernel; the
    engine's integer path takes the first hit only."""
    x = torch.zeros((3, 2))
    feat = torch.zeros((1, 1), dtype=torch.int32)
    thr = torch.full((1, 1), -float("inf"))
    A = torch.zeros((1, 4, 32), dtype=torch.int8)
    Bvec = torch.tensor([[0, 0, 5, 5]], dtype=torch.int32)
    leaf_val = torch.tensor([[[1.0], [2.0], [4.0], [8.0]]])
    got = gemm_forward(x, feat, thr, A, Bvec, leaf_val,
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
    with pytest.raises(TypeError, match="planes: dtype"):
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
    with pytest.raises(TypeError, match="A: dtype"):
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
    assert out.shape == (3, 1) and calls == [((16, 6), 5, torch.float32)]
    with pytest.raises(ValueError, match="width"):
        pred.predict_transformed(np.zeros((3, 1), dtype=np.float32))


# (B, d, T, N, G or L, C): the MSN forest, the mnist cascade's, the widest
# trees the kernels take, and rows too wide for a shared-memory x tile
TILE_SHAPES = [(1024, 136, 1024, 63, 8, 1), (1024, 784, 512, 63, 64, 10),
               (300, 136, 5, 255, 86, 16), (300, 2000, 64, 63, 64, 10)]


def test_tree_chunks_fit_shared_memory():
    """Each kernel's ring of chunk trees and its x tile fit the shared
    memory of a block, as the sources reckon it; the chunk is one tree a
    warp at most, the tree groups cover every tree, and only the row blocks
    change with B."""
    for B, d, T, N, G, C in TILE_SHAPES:
        for layout, tree in (
                (qk.bitmm_layout, launch.tile_tree_bytes(
                    N, 3 * launch.round_up(G, 8), G)),
                (gk.gemm_layout, launch.tile_tree_bytes(
                    N, launch.round_up(G, 8), G))):
            lay = layout(B, d, T, N, G, C, n_sm=132)
            assert lay.route == ("global_x" if d == 2000 else "smem_x")
            assert 1 <= lay.chunk <= min(T, 8)
            assert lay.shared_bytes == launch.tile_shared_bytes(
                tree, C, d, lay.chunk, lay.route == "smem_x")
            assert lay.shared_bytes <= launch.MAX_SHARED_BYTES
            assert (lay.n_groups - 1) * lay.group_trees < T <= \
                lay.n_groups * lay.group_trees
            assert layout(455, d, T, N, G, C, n_sm=132) == \
                dataclasses.replace(lay, row_blocks=-(-455 // 32))
    assert launch.tile_tree_bytes(63, 24, 8) == 512 + 24 * 80 + 32
    assert [launch.node_pad(n) for n in (0, 1, 32, 33, 255, 256)] == \
        [32, 32, 32, 64, 256, 256]


# --------------------------------------------------------------------------- #
# the operands against the reference's, and the plain versions on them
# against the Pallas kernels
# --------------------------------------------------------------------------- #
OPERAND_FORESTS = [FOREST_SWEEP[0], FOREST_SWEEP[3], FOREST_SWEEP[4]]


@pytest.mark.parametrize("T,L,d,C,full,seed", OPERAND_FORESTS)
def test_bitmm_planes_round_trip_to_reference(T, L, d, C, full, seed):
    """The byte planes join into the reference's packed words
    (``repro.core.quickscorer.bitmm_pack_arrays``), with its bias and
    field layout, tree for tree."""
    from repro.core.quickscorer import bitmm_pack_arrays
    forest = rcore.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                    full=full)
    packed, bias, bits, npack = bitmm_pack_arrays(forest)
    (_, _, planes, tbias, _), tbits, tnpack = ops._bitmm_arrays(port(forest),
                                                               4)
    assert (tbits, tnpack) == (bits, npack)
    got = qk.packed_words(torch.from_numpy(planes), packed.shape[1]).numpy()
    np.testing.assert_array_equal(got[:T], np.asarray(packed))
    np.testing.assert_array_equal(tbias[:T], np.asarray(bias))


@pytest.mark.parametrize("T,L,d,C,full,seed", OPERAND_FORESTS)
def test_gemm_operand_round_trips_to_reference(T, L, d, C, full, seed):
    """The int8 operand is the reference's A (``compile_gemm``) leaf-major,
    and Bvec is its Bvec, tree for tree."""
    forest = rcore.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                    full=full)
    g = rcore.compile_gemm(forest)
    feat, _, A8, Bvec, _ = ops._gemm_arrays(port(forest), 4)
    A = gk.node_matrix(torch.from_numpy(A8), feat.shape[1]).numpy()
    np.testing.assert_array_equal(A[:T], np.asarray(g.A))
    np.testing.assert_array_equal(Bvec[:T], np.asarray(g.Bvec))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("T,L,d,C,full,seed", OPERAND_FORESTS)
def test_plain_version_on_new_operands_matches_pallas_kernel(
        kernel, T, L, d, C, full, seed):
    """The plain version on the tensor-core operands against the Pallas
    kernel itself in interpret mode, on the reference's own operands, one
    block of rows and trees: float within 1e-5 / 1e-6, int16 bit-exact."""
    from repro.kernels import gemm_forest_kernel as rgk
    from repro.kernels import ops as rops
    from repro.kernels import quickscorer_kernel as rqk
    forest = rcore.random_forest_ir(T, L, d, n_classes=C, seed=seed,
                                    full=full)
    X = rows(16, d, seed + 300)
    for f in (forest, rcore.quantize_forest(forest, X, INT16)):
        xq = rcore.quantize_inputs(f, X).astype(np.float32)
        tf = port(f)
        out_dtype = ops._out_dtype(tf, 8)
        x = torch.from_numpy(xq)
        if kernel == "bitmm":
            arrays, bits, npack = ops._bitmm_arrays(tf, 8)
            got = qs_bitmm_forward_reference(
                x, *map(torch.from_numpy, arrays), bits=bits, npack=npack,
                n_leaves=tf.n_leaves, out_dtype=out_dtype)
            packed, bias, _, _ = rcore.quickscorer.bitmm_pack_arrays(f)
            feat, thr, _, _, leaf_val = arrays
            bias = rops._pad_to(np.asarray(bias), 0, 8, fill=float(
                rcore.quickscorer.bitmm_full_word(bits, npack)))
            want = rqk.qs_bitmm_forward(
                xq, feat, thr, rops._pad_to(np.asarray(packed), 0, 8), bias,
                leaf_val, bits=bits, npack=npack, n_leaves=f.n_leaves,
                block_b=16, block_t=8, interpret=True,
                out_dtype=rops._out_dtype(f, 8))
        else:
            arrays = ops._gemm_arrays(tf, 8)
            got = gemm_forward_reference(x, *map(torch.from_numpy, arrays),
                                         out_dtype=out_dtype)
            feat, thr, A8, Bvec, leaf_val = arrays
            A = gk.node_matrix(torch.from_numpy(A8), feat.shape[1]).numpy()
            want = rgk.gemm_forward(
                xq, feat, thr, A, Bvec.astype(np.float32), leaf_val,
                block_b=16, block_t=8, interpret=True,
                out_dtype=rops._out_dtype(f, 8))
        want = np.asarray(want)
        if f.int_accum:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-6)


# --------------------------------------------------------------------------- #
# kernel limits, checked when the predictor is built
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("engine", ["bitvector", "bitmm", "gemm", "cascade"])
def test_compile_rejects_what_the_kernel_cannot_take(engine):
    """An L = 512 forest (511 nodes, 16 leafidx words) compiled for the
    card raises when it is built, naming the torch backend, and moves
    nothing there first (a CPU-only torch can make a cuda device, but not
    a tensor on it); the plain versions on the CPU still take it."""
    from repro_torch.cascade import CascadeSpec
    forest = tcore.random_forest_ir(2, 512, 4, n_classes=1, seed=0,
                                    full=True)
    kw = dict(engine="bitvector", cascade=CascadeSpec((1, 2), fused=True)) \
        if engine == "cascade" else dict(engine=engine)
    with pytest.raises(ValueError, match='at most.*backend="torch"'):
        tcore.compile_forest(forest, backend="cuda", device="cuda", **kw)
    X = rows(3, 4, 0)
    got = tcore.compile_forest(forest, backend="cuda", device="cpu",
                               **kw).predict(X)
    want = tcore.compile_forest(forest, backend="torch", device="cpu",
                                **kw).predict(X)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_limit_functions_name_the_torch_backend():
    """Each kernel module's limits function reads shapes only and passes
    what the kernel takes."""
    from repro_torch.kernels import cascade_kernel as ck
    small = [np.zeros(s) for s in ((2, 63), (2, 63), (2, 63, 2), (2, 2),
                                   (2, 64, 16))]
    for limits in (qk.qs_forward_limits, ck.cascade_qs_forward_limits,
                   qk.qs_bitmm_forward_limits, gk.gemm_forward_limits):
        limits(*small)
        with pytest.raises(ValueError, match='C=17.*backend="torch"'):
            limits(*small[:4], np.zeros((2, 64, 17)))
    wide = [np.zeros(s) for s in ((2, 257), (2, 257), (2, 257, 9), (2, 9),
                                  (2, 258, 1))]
    for limits, what in ((qk.qs_forward_limits, "W=9"),
                         (ck.cascade_qs_forward_limits, "W=9"),
                         (qk.qs_bitmm_forward_limits, "N=257"),
                         (gk.gemm_forward_limits, "N=257")):
        with pytest.raises(ValueError, match=what):
            limits(*wide)
