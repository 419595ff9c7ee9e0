"""The encoder-decoder family of the port (seamless-m4t-large-v2
``.reduced()``) against the reference, in f32 on the CPU: cross-attention
in ``attn_forward``, the encoder's non-causal GQA self-attention,
``cross_memory_kv``, ``cross_attn_decode``, ``Model.encode``, ``forward``,
``prefill`` with and without a decode state, ``init_decode_state``'s cross
K/V and ``decode_step``.  Weights are made by the reference
(``jax.random``) and carried across as numpy by ``models/convert.py``;
encoder frame embeddings and tokens are numpy from a seed.

Tolerances (those of ``tests/test_torch_lm_families.py``): f32 layers and
logits rtol/atol 1e-4 (the same arithmetic in another order); bf16 caches
and cross K/V one bf16 step (1e-2); teacher-forced decode vs forward 2e-2
(``tests/test_models_smoke.py:92``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.inference.server import LMServer as RefLMServer  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.inference import LMServer  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.layers import ShapeMaker  # noqa: E402
from repro_torch.models.model import Model, make_params  # noqa: E402

NAME = "seamless_m4t_large_v2"
BACKENDS = ["torch", "cuda"]
RTOL = ATOL = 1e-4
BF16_TOL = 1e-2
DECODE_TOL = 2e-2
B, S, S_ENC = 2, 32, 16


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def _enc(d_model, seed=11, s_enc=S_ENC):
    return np.random.default_rng(seed).normal(
        0, 1, size=(B, s_enc, d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def encdec():
    """(reduced config, reference f32 model, reference params, the params
    as numpy, encoder embeddings, a cache of reference results)."""
    cfg = ref_configs.get_config(NAME).reduced()
    model = RefModel(cfg, compute_dtype=jnp.float32, q_chunk=16,
                     remat=False)
    params = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    return (cfg, model, params, jax.tree.map(np.asarray, params),
            _enc(cfg.d_model), {})


def _port(npp, backend):
    cfg = configs.get_config(NAME).reduced()
    model = Model(cfg, torch.float32, q_chunk=16, backend=backend,
                  device="cpu")
    return model, params_from_reference(npp, cfg)


def _leaf(params, stack, sub):
    """Unit 0's ``sub`` attention params of ``stack`` (reference tree)."""
    return jax.tree.map(lambda a: a[0], params[stack]["pos0"][sub])


def _torch_tree(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _cached(cache, key, fn):
    if key not in cache:
        cache[key] = fn()
    return cache[key]


# ---------------------------------------------------------------- params
def test_param_tree_and_count_match_reference(encdec):
    """The decoder's ``ln_cross``/``cross`` (full MHA) and the encoder's
    ``enc_blocks``/``enc_norm``: the reference's leaves, shapes and
    dtypes; the analytic ``param_count()`` within 2% of the real tree
    (``tests/test_models_smoke.py:56-64``), at reduced and full size."""
    cfg, _, _, npp, _, _ = encdec
    model = Model(cfg, torch.float32, backend="torch", device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(npp)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), model.init_params(0)))[0]
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert [v.shape for _, v in got] == [v.shape for _, v in ref]
    assert all(v.dtype == np.float32 for _, v in got)
    cross = npp["blocks"]["pos0"]["cross"]
    assert cross["wk"].shape == (cfg.n_layers, cfg.d_model, cfg.n_heads,
                                 cfg.head_dim)
    n = sum(int(np.prod(v.shape)) for _, v in got)
    assert abs(n - cfg.param_count()) / n < 0.02
    full = configs.get_config(NAME)
    shapes = jax.tree.leaves(make_params(full, ShapeMaker()),
                             is_leaf=lambda t: isinstance(t, tuple))
    n_full = sum(int(np.prod(s)) for s in shapes)
    assert full.param_count() == 1_632_130_048
    assert abs(n_full - full.param_count()) / n_full < 0.02
    tp = params_from_reference(npp, cfg)
    np.testing.assert_array_equal(tp["enc_norm"].numpy(), npp["enc_norm"])
    np.testing.assert_array_equal(
        tp["blocks"]["pos0"]["cross"]["wv"].numpy(), cross["wv"])


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("backend", BACKENDS)
def test_attn_forward_with_memory_matches_reference(encdec, backend):
    """Cross-attention: K and V from a memory of another length, no
    RoPE, no mask, full MHA (n_rep 1)."""
    cfg, _, params, _, _, _ = encdec
    p = _leaf(params, "blocks", "cross")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mem = rng.normal(size=(B, S_ENC, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want = ref_attn.attn_forward(p, jnp.asarray(x), cfg, jnp.asarray(pos),
                                 causal=True, memory=jnp.asarray(mem),
                                 q_chunk=16)
    got = attention.attn_forward(_torch_tree(p), torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos), causal=True,
                                 memory=torch.from_numpy(mem), q_chunk=16,
                                 backend=backend)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_encoder_self_attention_is_non_causal_gqa(encdec, backend):
    """The encoder's attention: RoPE, GQA (4 heads over 2 kv heads at
    reduced size) and no mask — and it differs from the causal one."""
    cfg, _, params, _, _, _ = encdec
    assert cfg.n_heads // cfg.n_kv == 2
    p = _leaf(params, "enc_blocks", "attn")
    x = np.random.default_rng(4).normal(size=(B, S_ENC, cfg.d_model)) \
        .astype(np.float32)
    pos = np.tile(np.arange(S_ENC, dtype=np.int32), (B, 1))
    want = ref_attn.attn_forward(p, jnp.asarray(x), cfg, jnp.asarray(pos),
                                 causal=False, q_chunk=16)
    args = (_torch_tree(p), torch.from_numpy(x), cfg, torch.from_numpy(pos))
    got = attention.attn_forward(*args, causal=False, q_chunk=16,
                                 backend=backend)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    causal = attention.attn_forward(*args, causal=True, q_chunk=16,
                                    backend=backend)
    assert not torch.allclose(causal, got, rtol=RTOL, atol=ATOL)


# (memory dtype, K/V dtype): f32 throughout; the reference's decode state
# (bf16 memory of a bf16 model against f32 masters, stored bf16); an f32
# memory stored bf16
@pytest.mark.parametrize("mem_dt,dt", [("float32", "float32"),
                                       ("bfloat16", "bfloat16"),
                                       ("float32", "bfloat16")])
def test_cross_memory_kv_matches_reference(encdec, mem_dt, dt):
    cfg, _, params, _, _, _ = encdec
    p = _leaf(params, "blocks", "cross")
    mem = np.random.default_rng(5).normal(size=(B, S_ENC, cfg.d_model)) \
        .astype(np.float32)
    want = ref_attn.cross_memory_kv(p, jnp.asarray(mem, mem_dt),
                                    getattr(jnp, dt))
    got = attention.cross_memory_kv(
        _torch_tree(p), torch.from_numpy(mem).to(getattr(torch, mem_dt)),
        getattr(torch, dt))
    tol = RTOL if dt == "float32" else BF16_TOL
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dt)
        assert tuple(g.shape) == (B, S_ENC, cfg.n_heads, cfg.head_dim)
        np.testing.assert_allclose(g.float().numpy(), _np(w), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("mem_dt", ["float32", "bfloat16"])
def test_cross_attn_decode_matches_reference(encdec, mem_dt):
    """One query against every memory position: f32 scores, the weights
    in x's dtype; a bf16 memory K/V read by an f32 model."""
    cfg, _, params, _, _, _ = encdec
    p = _leaf(params, "blocks", "cross")
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    mk, mv = (rng.normal(size=(B, S_ENC, cfg.n_heads, cfg.head_dim))
              .astype(np.float32) for _ in range(2))
    want = ref_attn.cross_attn_decode(p, jnp.asarray(x), cfg,
                                      jnp.asarray(mk, mem_dt),
                                      jnp.asarray(mv, mem_dt))
    tdt = getattr(torch, mem_dt)
    got = attention.cross_attn_decode(
        _torch_tree(p), torch.from_numpy(x), cfg,
        torch.from_numpy(mk).to(tdt), torch.from_numpy(mv).to(tdt))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_matches_reference(encdec, backend):
    cfg, ref_model, params, npp, enc, cache = encdec
    model, tp = _port(npp, backend)
    want = _cached(cache, "encode", lambda: _np(
        ref_model.encode(params, jnp.asarray(enc))))
    got = model.encode(tp, enc)
    assert got.shape == (B, S_ENC, cfg.d_model)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_and_prefill_match_reference(encdec, backend):
    """``forward(params, tokens, enc_embeds)`` and the stateless
    ``prefill(..., enc_embeds=)``, which encode first, as the reference's
    trunk does."""
    cfg, ref_model, params, npp, enc, cache = encdec
    model, tp = _port(npp, backend)
    toks = _tokens(cfg.vocab, (B, S), seed=5)
    want = _cached(cache, "forward", lambda: (
        _np(ref_model.forward(params, jnp.asarray(toks), jnp.asarray(enc))),
        _np(ref_model.prefill(params, jnp.asarray(toks),
                              jnp.asarray(enc)))))
    got = model.forward(tp, toks, enc)
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), want[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        model.prefill(tp, toks, enc_embeds=enc).numpy(), want[1],
        rtol=RTOL, atol=ATOL)


def _ref_state(cache, ref_model, params, enc, max_len, dtype=jnp.bfloat16,
               kv_quant=False):
    key = ("state", max_len, str(dtype), kv_quant)
    return _cached(cache, key, lambda: ref_model.init_decode_state(
        B, max_len, params=params, enc_embeds=jnp.asarray(enc), dtype=dtype,
        kv_quant=kv_quant))


@pytest.mark.parametrize("dt", ["bfloat16", "float32"])
def test_init_decode_state_holds_the_reference_cross_kv(encdec, dt):
    """The state's keys, shapes and dtypes are the reference's; its cross
    K/V (U, B, S_enc, H, hd) come from the f32 masters against the
    encoder's output, stored in ``dtype``."""
    cfg, ref_model, params, npp, enc, cache = encdec
    model, tp = _port(npp, "torch")
    want = _ref_state(cache, ref_model, params, enc, 12, getattr(jnp, dt))
    got = model.init_decode_state(B, 12, params=tp, enc_embeds=enc,
                                  dtype=getattr(torch, dt))
    assert set(got) == set(want)
    assert got["index"] == 0
    for k in want:
        if k == "index":
            continue
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    assert tuple(got["cross_k"].shape) == (cfg.n_layers, B, S_ENC,
                                           cfg.n_heads, cfg.head_dim)
    tol = RTOL if dt == "float32" else BF16_TOL
    for k in ("cross_k", "cross_v"):
        np.testing.assert_allclose(got[k].float().numpy(), _np(want[k]),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_with_state_matches_sequential_prefill(encdec, backend):
    """The one-pass prefill over a state from ``init_decode_state(params=,
    enc_embeds=)`` against the reference ``LMServer._prefill`` (S
    teacher-forced decode steps) on the reference's state: index, the last
    position's logits, and the bf16 K/V caches.  The cross sub-blocks read
    the state's bf16 cross K/V, as the decode steps do."""
    cfg, ref_model, params, npp, enc, cache = encdec
    model, tp = _port(npp, backend)
    prompts = _tokens(cfg.vocab, (B, 12), seed=6)

    def ref_prefill():
        state = _ref_state(cache, ref_model, params, enc, 20)
        return RefLMServer(ref_model, params, batch=B, max_len=20)._prefill(
            params, state, jnp.asarray(prompts))
    ref_state, ref_logits = _cached(cache, "prefill", ref_prefill)
    state = model.init_decode_state(B, 20, params=tp, enc_embeds=enc)
    logits = model.prefill(tp, prompts, state)
    assert state["index"] == int(ref_state["index"]) == 12
    np.testing.assert_allclose(logits.numpy(), _np(ref_logits), rtol=RTOL,
                               atol=ATOL)
    for k in ("k", "v"):
        assert state[k].dtype == torch.bfloat16
        np.testing.assert_allclose(state[k].float().numpy(),
                                   _np(ref_state[k]), rtol=BF16_TOL,
                                   atol=BF16_TOL)
        assert not state[k][:, :, :, 12:].any()


@pytest.mark.parametrize("kv_quant", [False, True])
def test_decode_step_matches_reference(encdec, kv_quant):
    """Teacher-forced ``decode_step`` from the state of
    ``init_decode_state(params=, enc_embeds=)`` against the reference's,
    step by step: f32 caches and cross K/V, or the int8 cache with its
    scales (the reference's int8 arithmetic, the bf16 roundings
    included)."""
    cfg, ref_model, params, npp, enc, cache = encdec
    model, tp = _port(npp, "torch")
    toks = _tokens(cfg.vocab, (B, 8), seed=2)
    ref_state = _ref_state(cache, ref_model, params, enc, 9, jnp.float32,
                           kv_quant)
    step = jax.jit(ref_model.decode_step)
    state = model.init_decode_state(B, 9, params=tp, enc_embeds=enc,
                                    dtype=torch.float32, kv_quant=kv_quant)
    for i in range(8):
        want, ref_state = step(params, ref_state, toks[:, i:i + 1])
        got, state = model.decode_step(tp, state, toks[:, i:i + 1])
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)
    assert state["index"] == 8
    for k in ("k_scale", "v_scale") if kv_quant else ():
        np.testing.assert_allclose(state[k].numpy(), _np(ref_state[k]),
                                   rtol=RTOL, atol=0)


def test_decode_matches_forward(encdec):
    """tests/test_models_smoke.py:67-92 on the port's encdec model:
    teacher-forced decode steps reproduce ``forward`` (f32 state)."""
    cfg, _, _, npp, enc, _ = encdec
    model, tp = _port(npp, "cuda")
    toks = _tokens(cfg.vocab, (B, 8), seed=2)
    full = model.forward(tp, toks, enc).numpy()
    state = model.init_decode_state(B, 9, params=tp, enc_embeds=enc,
                                    dtype=torch.float32)
    got = []
    for i in range(8):
        logits, state = model.decode_step(tp, state, toks[:, i:i + 1])
        got.append(logits.numpy())
    np.testing.assert_allclose(np.stack(got, axis=1), full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


# ------------------------------------------------------------ refusals
def test_encdec_entry_points_refuse_what_they_cannot_take(encdec):
    """No encoder input, or two of them; ``init_decode_state`` without
    params or embeddings (the reference asserts); and ``LMServer``, whose
    ``generate`` takes no encoder embeddings, as the reference's."""
    cfg, _, _, npp, enc, _ = encdec
    model, tp = _port(npp, "torch")
    toks = _tokens(cfg.vocab, (B, 4), seed=0)
    with pytest.raises(ValueError, match="enc_embeds"):
        model.forward(tp, toks)
    with pytest.raises(ValueError, match="enc_embeds"):
        model.init_decode_state(B, 8, params=tp)
    with pytest.raises(ValueError, match="enc_embeds"):
        model.init_decode_state(B, 8, enc_embeds=enc)
    state = model.init_decode_state(B, 8, params=tp, enc_embeds=enc)
    with pytest.raises(ValueError, match="cross K/V"):
        model.prefill(tp, toks, state, enc_embeds=enc)
    with pytest.raises(ValueError, match="encdec"):
        LMServer(model, tp, batch=B, max_len=8)
