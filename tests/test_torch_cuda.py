"""The CUDA kernel on the card: tests that need an NVIDIA GPU and nvcc.

Each test skips here, without a card.  On the card they run with

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` imports the JAX reference,
which a GPU host need not have; this file imports only ``repro_torch``.)
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quickscorer_kernel import (  # noqa: E402
    qs_forward, qs_forward_reference)

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
        got = qs_forward(x, *arrays, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert qs_forward.launches == before + 1
        want = qs_forward_reference(x, *arrays, out_dtype=out_dtype)
        if out_dtype == torch.int32:
            assert torch.equal(got, want)
        else:
            # up to 1024 f32 leaves summed in two orders
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-3)
        # deterministic: no atomics, a fixed reduction order
        assert torch.equal(got, qs_forward(x, *arrays, out_dtype=out_dtype))


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
