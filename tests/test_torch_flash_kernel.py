"""The port's flash attention against the reference: ``flash_forward`` /
``flash_attention_bshd`` on CPU tensors (the CUDA kernel's plain version)
and the ``backend="torch"`` chunked flash, each held against the Pallas
kernel in interpret mode, the reference's pure-JAX chunked flash and a
naive softmax, on the same numpy inputs.  Tolerances are the reference
test's (``tests/test_flash_kernel.py``): 2e-5 against the naive softmax
and the kernel, rtol 1e-5 / atol 1e-6 between the two chunked flashes,
3e-2 for bf16 inputs."""
import pytest

torch = pytest.importorskip("torch")

import functools  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attention_kernel import \
    flash_attention_bshd as ref_kernel_bshd  # noqa: E402
from repro.kernels.flash_attention_kernel import \
    flash_forward as ref_flash_forward  # noqa: E402
from repro.models.attention import \
    flash_attention as ref_flash  # noqa: E402
from repro_torch.kernels import flash_attention_kernel as fk  # noqa: E402
from repro_torch.models.attention import flash_attention  # noqa: E402

# (B, Sq, Sk, H, K, hd, causal, bq, bk) — tests/test_flash_kernel.py:29-35
SWEEP = [
    (1, 32, 32, 4, 4, 8, True, 8, 8),        # MHA causal
    (2, 64, 64, 6, 2, 16, True, 16, 16),     # GQA 3:1
    (2, 64, 64, 8, 1, 16, True, 32, 16),     # MQA
    (1, 48, 96, 4, 4, 8, False, 16, 32),     # cross-shaped, non-causal
    (2, 128, 128, 15, 5, 4, True, 64, 32),   # smollm-like ratios
]
# ragged shapes no tile divides (the port takes any Sq and Sk)
RAGGED = [
    (1, 37, 37, 6, 2, 8, True),
    (2, 23, 53, 4, 1, 16, True),             # Sq < Sk: top-left causal mask
    (1, 53, 23, 3, 3, 4, True),              # Sq > Sk
    (1, 29, 41, 4, 2, 8, False),
]


def _qkv(B, Sq, Sk, H, K, hd, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(dtype),
            rng.normal(size=(B, Sk, K, hd)).astype(dtype),
            rng.normal(size=(B, Sk, K, hd)).astype(dtype))


def _naive(q, k, v, causal, scale=None):
    """Softmax attention in float64 numpy, GQA by repeating k/v heads;
    ``scale`` defaults to hd^-½."""
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    rep = q.shape[2] // k.shape[2]
    k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = np.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = np.arange(q.shape[1])[:, None] >= np.arange(k.shape[1])
        s = np.where(mask, s, -1e30)
    w = np.exp(s - s.max(axis=-1, keepdims=True))
    w /= w.sum(axis=-1, keepdims=True)
    return np.einsum("bhqk,bkhd->bqhd", w, v)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _pallas(B, Sq, Sk, H, K, hd, causal, bq, bk):
    """The Pallas kernel in interpret mode on a sweep shape's inputs, once
    per shape."""
    q, k, v = _qkv(B, Sq, Sk, H, K, hd, seed=B * Sq + H)
    return np.asarray(ref_kernel_bshd(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      block_q=bq, block_k=bk))


@pytest.fixture(params=[16, 512], ids=["chunk16", "chunk512"])
def plain_block(request, monkeypatch):
    """Runs the plain version with several key/query chunks per sweep
    shape, and with one."""
    monkeypatch.setattr(fk, "PLAIN_BLOCK", request.param)
    return request.param


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,bq,bk", SWEEP)
def test_plain_kernel_matches_pallas_and_naive(plain_block, B, Sq, Sk, H,
                                               K, hd, causal, bq, bk):
    q, k, v = _qkv(B, Sq, Sk, H, K, hd, seed=B * Sq + H)
    got = fk.flash_attention_bshd(_t(q), _t(k), _t(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, Sq, H, hd)
    got = got.numpy()
    want = _pallas(B, Sq, Sk, H, K, hd, causal, bq, bk)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, _naive(q, k, v, causal), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", RAGGED)
def test_plain_kernel_ragged_shapes(plain_block, B, Sq, Sk, H, K, hd,
                                    causal):
    q, k, v = _qkv(B, Sq, Sk, H, K, hd, seed=Sq + Sk)
    got = fk.flash_attention_bshd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, causal),
                               rtol=2e-5, atol=2e-5)


def test_plain_kernel_matches_reference_chunked_flash():
    """tests/test_flash_kernel.py:50-62: the kernel and the XLA engine are
    the same math at different memory-hierarchy levels."""
    B, S, K, R, hd = 2, 64, 3, 5, 16
    q, k, v = _qkv(B, S, S, K * R, K, hd, seed=0)
    got = fk.flash_attention_bshd(_t(q), _t(k), _t(v), causal=True)
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, q_chunk=16, k_chunk=16, n_rep=R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_forward_head_major_gqa(causal):
    """The head-major entry: kv row bh // n_rep, 15 heads over 5."""
    B, S, K, R, hd = 2, 40, 5, 3, 8
    q, k, v = _qkv(B, S, S, K * R, K, hd, seed=7)
    qh = _t(q.transpose(0, 2, 1, 3).reshape(B * K * R, S, hd))
    kh = _t(k.transpose(0, 2, 1, 3).reshape(B * K, S, hd))
    vh = _t(v.transpose(0, 2, 1, 3).reshape(B * K, S, hd))
    got = fk.flash_forward(qh, kh, vh, causal=causal, n_rep=R)
    want = _naive(q, k, v, causal).transpose(0, 2, 1, 3).reshape(
        B * K * R, S, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("engine", ["kernel", "torch"])
def test_bf16_inputs(engine):
    """tests/test_flash_kernel.py:65-76: bf16 in, bf16 out, 3e-2."""
    B, S, H, hd = 1, 32, 4, 8
    q, k, v = (_t(a).to(torch.bfloat16) for a in _qkv(B, S, S, H, H, hd, 3))
    if engine == "kernel":
        got = fk.flash_attention_bshd(q, k, v, causal=True)
    else:
        got = flash_attention(q, k, v, causal=True, q_chunk=8, k_chunk=8)
    assert got.dtype == torch.bfloat16
    want = _naive(*(a.float().numpy() for a in (q, k, v)), True)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal,bq,bk", SWEEP)
def test_torch_engine_matches_reference_chunked_flash(B, Sq, Sk, H, K, hd,
                                                      causal, bq, bk):
    """``backend="torch"``: the chunked flash of ``models/attention.py``
    against the reference's at the same chunks, and the naive softmax."""
    q, k, v = _qkv(B, Sq, Sk, H, K, hd, seed=B * Sq + H)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=bq,
                          k_chunk=bk, n_rep=H // K).numpy()
    want = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal, q_chunk=bq, k_chunk=bk, n_rep=H // K)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _naive(q, k, v, causal), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("B,Sq,Sk,H,K,hd,causal", RAGGED)
def test_torch_engine_ragged_shapes(B, Sq, Sk, H, K, hd, causal):
    q, k, v = _qkv(B, Sq, Sk, H, K, hd, seed=Sq * Sk)
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, q_chunk=16,
                          k_chunk=16, n_rep=H // K)
    np.testing.assert_allclose(got.numpy(), _naive(q, k, v, causal),
                               rtol=2e-5, atol=2e-5)


def test_wrapper_rejects_what_it_cannot_take():
    q = torch.zeros(6, 8, 16)
    kv = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="n_rep"):
        fk.flash_forward(q, kv, kv, n_rep=2)
    with pytest.raises(TypeError, match="dtype"):
        fk.flash_forward(q, kv.double(), kv, n_rep=3)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fk.flash_forward(q.half(), kv.half(), kv.half(), n_rep=3)
    with pytest.raises(ValueError, match="inconsistent"):
        fk.flash_forward(q, kv, torch.zeros(2, 9, 16), n_rep=3)
    with pytest.raises(ValueError, match="contiguous"):
        fk.flash_forward(q.transpose(0, 1), kv, kv, n_rep=3)
    with pytest.raises(ValueError, match="kv heads"):
        fk.flash_attention_bshd(torch.zeros(1, 8, 5, 16),
                                torch.zeros(1, 8, 2, 16),
                                torch.zeros(1, 8, 2, 16))
    assert fk.flash_forward.launches == 0      # the CPU never launches


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "simt")])
def test_route_is_chosen_by_dtype(dtype, route):
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one; on
    the CPU neither launches nor counts."""
    assert fk.flash_route(dtype) == route
    before = dict(fk.flash_forward.launches_by_route)
    q = torch.zeros(3, 8, 16, dtype=dtype)
    fk.flash_forward(q, q[:1].clone(), q[:1].clone(), n_rep=3)
    assert fk.flash_forward.launches_by_route == before


@pytest.mark.parametrize("hd", [4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_zero_padding_is_exact(hd, causal):
    """What the wgmma route does below 16 columns (the wrapper widens hd 4
    to 8 for TMA, the kernel's tile zero-fills to 16): the attention over
    zero-padded q, k, v at hd's own scale, cut back to hd columns, is the
    attention over the unpadded ones, which the plain version and the
    Pallas kernel compute."""
    assert fk.tma_head_dim(hd) == 8
    B, S, H, K = 1, 24, 4, 2
    q, k, v = _qkv(B, S, S, H, K, hd, seed=hd)
    padded = [np.pad(a, ((0, 0), (0, 0), (0, 0), (0, 16 - hd)))
              for a in (q, k, v)]
    got = _naive(*padded, causal, scale=hd ** -0.5)
    assert not got[..., hd:].any()
    np.testing.assert_allclose(got[..., :hd], _naive(q, k, v, causal),
                               rtol=1e-12, atol=1e-12)
    plain = fk.flash_attention_bshd(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(plain.numpy(), got[..., :hd], rtol=2e-5,
                               atol=2e-5)
    ref = np.asarray(ref_kernel_bshd(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     block_q=8, block_k=8))
    np.testing.assert_allclose(ref, got[..., :hd], rtol=2e-5, atol=2e-5)


# query chunks of one whole sequence (head-major, S keys): (Sq, offset)
# at the start, mid-sequence and at the end (offset S - Sq)
OFFSET_S = 64
OFFSET_CHUNKS = [(16, 0), (16, 24), (16, 48), (40, 24)]


def _head_major(B, S, H, K, hd, dtype):
    """Seeded head-major q (B·H, S, hd) and k/v (B·K, S, hd) as numpy."""
    q, k, v = _qkv(B, S, S, H, K, hd, seed=H * 7 + K, dtype=np.float32)
    out = [a.transpose(0, 2, 1, 3).reshape(-1, S, hd) for a in (q, k, v)]
    return [np.ascontiguousarray(a) for a in out]


@functools.lru_cache(maxsize=None)
def _pallas_whole(H, K, causal, bf16):
    """The Pallas ``flash_forward`` in interpret mode over the whole
    sequence (one block of queries and keys), once per case."""
    q, k, v = (jnp.asarray(a, jnp.bfloat16 if bf16 else jnp.float32)
               for a in _head_major(2, OFFSET_S, H, K, 8, np.float32))
    return np.asarray(ref_flash_forward(
        q, k, v, causal=causal, block_q=OFFSET_S, block_k=OFFSET_S,
        n_rep=H // K, interpret=True).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,off", OFFSET_CHUNKS)
@pytest.mark.parametrize("H,K", [(4, 4), (6, 2)], ids=["n_rep1", "n_rep3"])
def test_plain_kernel_query_offset_matches_pallas_rows(plain_block, dtype,
                                                       Sq, off, H, K):
    """``flash_forward_reference(..., q_offset=off)`` on the query chunk
    ``[off:off + Sq]`` equals those rows of the Pallas kernel over the
    whole sequence (``src/repro/kernels/flash_attention_kernel.py:86``,
    interpret mode): f32 at rtol 1e-5 / atol 1e-6, bf16 at the file's
    3e-2."""
    bf16 = dtype == "bfloat16"
    tdt = torch.bfloat16 if bf16 else torch.float32
    q, k, v = (_t(a).to(tdt) for a in _head_major(2, OFFSET_S, H, K, 8,
                                                  np.float32))
    got = fk.flash_forward_reference(q[:, off:off + Sq].contiguous(), k, v,
                                     causal=True, n_rep=H // K, q_offset=off)
    assert got.dtype == tdt and got.shape == (q.shape[0], Sq, 8)
    want = _pallas_whole(H, K, True, bf16)[:, off:off + Sq]
    rtol, atol = (3e-2, 3e-2) if bf16 else (1e-5, 1e-6)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=atol)
    # the wrapper on a CPU tensor is the plain version, offset and all
    again = fk.flash_forward(q[:, off:off + Sq].contiguous(), k, v,
                             causal=True, n_rep=H // K, q_offset=off)
    assert torch.equal(again, got)


@pytest.mark.parametrize("off", [0, 24, 48])
def test_plain_kernel_non_causal_ignores_query_offset(off):
    """Without the causal mask every row sees every key: the offset
    changes nothing, and the rows equal the Pallas kernel's."""
    q, k, v = (_t(a) for a in _head_major(2, OFFSET_S, 6, 2, 8, np.float32))
    chunk = q[:, off:off + 16].contiguous()
    got = fk.flash_forward_reference(chunk, k, v, causal=False, n_rep=3,
                                     q_offset=off)
    assert torch.equal(got, fk.flash_forward_reference(chunk, k, v,
                                                       causal=False,
                                                       n_rep=3))
    np.testing.assert_allclose(got.numpy(), _pallas_whole(6, 2, False, False)
                               [:, off:off + 16], rtol=1e-5, atol=1e-6)


def test_query_offset_beyond_the_keys_is_refused():
    """A causal chunk must lie within the keys: ``q_offset + Sq > Sk`` and
    a negative offset raise ``ValueError`` (the same check runs before a
    card launch); at offset 0 the top-left mask still takes Sq > Sk."""
    q, kv = torch.zeros(3, 16, 8), torch.zeros(1, 40, 8)
    with pytest.raises(ValueError, match="q_offset 25"):
        fk.flash_forward(q, kv, kv, n_rep=3, q_offset=25)
    with pytest.raises(ValueError, match="q_offset -1"):
        fk.flash_forward(q, kv, kv, n_rep=3, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset 25"):
        fk.flash_attention_bshd(torch.zeros(1, 16, 3, 8),
                                torch.zeros(1, 40, 1, 8),
                                torch.zeros(1, 40, 1, 8), q_offset=25)
    assert fk.flash_forward(q, kv, kv, n_rep=3, q_offset=24).shape == q.shape
    assert fk.flash_forward(q, kv, kv, n_rep=3, causal=False,
                            q_offset=25).shape == q.shape
    short = torch.zeros(1, 8, 8)
    assert fk.flash_forward(q, short, short, n_rep=3).shape == q.shape
