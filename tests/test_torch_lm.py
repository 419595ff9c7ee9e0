"""The port's LM serving path against the reference, on reduced configs in
f32 on the CPU: configs, layers, attention, the dense model, weight
conversion and ``LMServer``.  Weights are made by the reference
(``jax.random``), carried across as numpy by ``models/convert.py``, so
both packages run the same model; token inputs are numpy from a seed.

Tolerances: f32 layers and whole-model logits agree to rtol/atol 1e-4
(the same arithmetic, summed in another order by another BLAS); KV caches
are bf16 (the reference's default cache dtype, also for an f32 model), so
cached K and V agree to one bf16 rounding step (rtol/atol 1e-2);
greedy tokens must be equal.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data import tokens as ref_tokens  # noqa: E402
from repro.inference.server import LMServer as RefLMServer  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import tokens  # noqa: E402
from repro_torch.inference import LMServer  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import Model, make_params  # noqa: E402

DENSE = [a for a in ref_configs.ARCH_IDS
         if ref_configs.get_config(a).family == "dense"]
# the encdec family, held in full in tests/test_torch_encdec.py; moe, ssm
# and hybrid in tests/test_torch_lm_families.py
OTHER = [a for a in ref_configs.ARCH_IDS
         if ref_configs.get_config(a).family == "encdec"]
BACKENDS = ["torch", "cuda"]
RTOL = ATOL = 1e-4
B, S = 2, 32


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    """(name, reduced config, reference f32 model, reference params, the
    params as numpy)."""
    cfg = ref_configs.get_config(request.param).reduced()
    model = RefModel(cfg, compute_dtype=jnp.float32, q_chunk=16,
                     remat=False)
    params = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    return request.param, cfg, model, params, jax.tree.map(np.asarray,
                                                           params)


def _port(name, npp, backend, dtype=torch.float32):
    cfg = configs.get_config(name).reduced()
    model = Model(cfg, dtype, q_chunk=16, backend=backend, device="cpu")
    return model, params_from_reference(npp, cfg)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


# --------------------------------------------------------------- configs
@pytest.mark.parametrize("name", ref_configs.ARCH_IDS)
def test_arch_config_matches_reference(name):
    ref, got = ref_configs.get_config(name), configs.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert got.active_param_count() == ref.active_param_count()
    assert dataclasses.asdict(got.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for shape in ref_configs.SHAPES.values():
        assert configs.shape_applicable(got, configs.SHAPES[shape.name]) == \
            ref_configs.shape_applicable(ref, shape)


def test_config_registry_and_aliases():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert configs._ALIASES == ref_configs._ALIASES
    assert configs.get_config("smollm-360m") == \
        configs.get_config("smollm_360m")
    assert sorted(configs.all_configs()) == sorted(ref_configs.ARCH_IDS)


def test_synthetic_tokens_match_reference():
    cfg = dict(vocab=49152, seq_len=64, global_batch=4, seed=3)
    got = tokens.SyntheticTokens(tokens.TokenPipelineConfig(**cfg))
    ref = ref_tokens.SyntheticTokens(ref_tokens.TokenPipelineConfig(**cfg))
    for step in (0, 5):
        np.testing.assert_array_equal(got.batch(step), ref.batch(step))
    np.testing.assert_array_equal(got.host_slice(1, 1, 2),
                                  ref.host_slice(1, 1, 2))


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    tdt = getattr(torch, dtype)
    got = layers.rmsnorm(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt))
    want = ref_layers.rmsnorm(jnp.asarray(x, dtype), jnp.asarray(w, dtype))
    assert got.dtype == tdt
    # bf16: one rounding of the normalized x, one of the product
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(_np(got.float()), _np(want), rtol=tol,
                               atol=tol)


def test_apply_rope():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 11, 3, 16)).astype(np.float32)
    pos = np.tile(np.arange(100, 111, dtype=np.int32), (2, 1))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                            10_000.0)
    want = ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    # angles up to 110 rad: cos/sin of two libms differ in the last bits
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_forward(kind):
    rng = np.random.default_rng(2)
    ref_p = ref_layers.make_mlp_params(
        ref_layers.RealMaker(jax.random.PRNGKey(1)), 32, 96, kind)
    p = {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}
    x = rng.normal(size=(3, 7, 32)).astype(np.float32)
    got = layers.mlp_forward(p, torch.from_numpy(x), kind)
    want = ref_layers.mlp_forward(ref_p, jnp.asarray(x), kind)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def test_real_maker_init_rules():
    mk = layers.RealMaker(0)
    w = mk((256, 8, 64), ("embed", "heads", "head_dim"))
    assert w.shape == (256, 8, 64) and w.dtype == torch.float32
    assert abs(float(w.std()) - (256 * 8) ** -0.5) < 0.05 * (256 * 8) ** -0.5
    assert float(mk((64, 4), ("a", "b"), init="embed").std()) > 0.8
    assert torch.equal(mk((3,), ("a",), init="ones"), torch.ones(3))
    assert torch.equal(mk((3,), ("a",), init="zeros"), torch.zeros(3))
    again = layers.RealMaker(0)((256, 8, 64), ("e", "h", "d"))
    assert torch.equal(w, again)                    # seeded


# ------------------------------------------------------------- attention
@pytest.mark.parametrize("backend", BACKENDS)
def test_attn_forward(dense, backend):
    name, cfg, _, params, npp = dense
    p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["attn"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    x = np.random.default_rng(3).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    want = ref_attn.attn_forward(p, jnp.asarray(x), cfg, jnp.asarray(pos),
                                 q_chunk=16)
    got = attention.attn_forward(tp, torch.from_numpy(x), cfg,
                                 torch.from_numpy(pos), q_chunk=16,
                                 backend=backend)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)


def test_attn_decode_step(dense):
    """One decode step over a cache holding 9 positions: the output, and
    the caches with the new token written at ``index``."""
    name, cfg, _, params, npp = dense
    p = jax.tree.map(lambda a: a[0], params["blocks"]["pos0"]["attn"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(4)
    Smax, index = 16, 9
    shape = (B, Smax, cfg.n_kv, cfg.head_dim)
    kc = rng.normal(size=shape).astype(np.float32)
    vc = rng.normal(size=shape).astype(np.float32)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    want, wk, wv = ref_attn.attn_decode_step(
        p, jnp.asarray(x), cfg, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(index, jnp.int32))
    got, gk, gv = attention.attn_decode_step(
        tp, torch.from_numpy(x), cfg, torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), index)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gk.numpy(), _np(wk), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gv.numpy(), _np(wv), rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- model
@pytest.mark.parametrize("backend", BACKENDS)
def test_model_forward_and_prefill(dense, backend):
    name, cfg, ref_model, params, npp = dense
    model, tp = _port(name, npp, backend)
    toks = _tokens(cfg.vocab, (B, S), seed=5)
    want = ref_model.forward(params, jnp.asarray(toks))
    got = model.forward(tp, toks)
    assert got.shape == (B, S, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    want = ref_model.prefill(params, jnp.asarray(toks))
    np.testing.assert_allclose(model.prefill(tp, toks).numpy(), _np(want),
                               rtol=RTOL, atol=ATOL)


def test_param_tree_matches_reference(dense):
    """Same leaves, shapes and dtypes as the reference's tree; the
    seeded torch init fills it."""
    name, cfg, _, params, npp = dense
    model = Model(cfg, torch.float32, backend="torch", device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(npp)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), model.init_params(0)))[0]
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert [v.shape for _, v in got] == [v.shape for _, v in ref]
    assert all(v.dtype == np.float32 for _, v in got)


def test_decode_matches_forward(dense):
    """tests/test_models_smoke.py:67-92 on the port: teacher-forced
    decode steps reproduce the forward logits within 2e-2 (f32 model, f32
    cache)."""
    name, cfg, _, _, npp = dense
    model, tp = _port(name, npp, "cuda")
    toks = _tokens(cfg.vocab, (B, 8), seed=2)
    full = model.forward(tp, toks).numpy()
    state = model.init_decode_state(B, 9, dtype=torch.float32)
    got = []
    for i in range(8):
        logits, state = model.decode_step(tp, state, toks[:, i:i + 1])
        got.append(logits.numpy())
    assert state["index"] == 8
    np.testing.assert_allclose(np.stack(got, axis=1), full, rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------- server
@pytest.mark.parametrize("backend", BACKENDS)
def test_lmserver_prefill_state_matches_reference(dense, backend):
    """The one-pass prefill against the reference ``LMServer._prefill``
    (S teacher-forced decode steps): bf16 K/V caches, index and the last
    position's f32 logits."""
    name, cfg, ref_model, params, npp = dense
    model, tp = _port(name, npp, backend)
    prompts = _tokens(cfg.vocab, (B, 12), seed=6)
    ref = RefLMServer(ref_model, params, batch=B, max_len=20)
    ref_state, ref_logits = ref._prefill(
        params, ref_model.init_decode_state(B, 20), jnp.asarray(prompts))
    server = LMServer(model, tp, batch=B, max_len=20)
    state, logits = server._prefill(model.init_decode_state(B, 20),
                                    prompts)
    assert state["index"] == int(ref_state["index"]) == 12
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), _np(ref_logits), rtol=RTOL,
                               atol=ATOL)
    for key in ("k", "v"):
        assert state[key].dtype == torch.bfloat16
        assert state[key].shape == ref_state[key].shape
        np.testing.assert_allclose(state[key].float().numpy(),
                                   _np(ref_state[key]), rtol=1e-2,
                                   atol=1e-2)
        assert not state[key][:, :, :, 12:].any()


@pytest.mark.parametrize("backend", BACKENDS)
def test_lmserver_generate_matches_reference(dense, backend):
    name, cfg, ref_model, params, npp = dense
    model, tp = _port(name, npp, backend)
    prompts = _tokens(cfg.vocab, (B, 10), seed=7)
    want = RefLMServer(ref_model, params, batch=B,
                       max_len=20).generate(prompts, 8)
    server = LMServer(model, tp, batch=B, max_len=20)
    got = server.generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (B, 18)
    np.testing.assert_array_equal(got, want)
    assert server.last_times["n_decode"] == 8


def test_lmserver_rejects_what_it_cannot_take(dense):
    """Too long a completion or another batch raise; ``kv_quant=True`` is
    taken (``tests/test_torch_kv_quant.py`` holds its tokens)."""
    name, cfg, _, _, npp = dense
    model, tp = _port(name, npp, "cuda")
    assert LMServer(model, tp, batch=B, max_len=20, kv_quant=True).kv_quant
    server = LMServer(model, tp, batch=B, max_len=20)
    with pytest.raises(ValueError, match="max_len"):
        server.generate(_tokens(cfg.vocab, (B, 16), 0), 8)
    with pytest.raises(ValueError, match="batch"):
        server.generate(_tokens(cfg.vocab, (B + 1, 4), 0), 2)


# --------------------------------------------------------------- convert
def test_convert_raises_on_a_bad_tree(dense):
    name, cfg, _, _, npp = dense
    cut = jax.tree.map(lambda a: a, npp)
    del cut["blocks"]["pos0"]["mlp"]["w_up"]
    with pytest.raises(ValueError, match="missing.*w_up"):
        params_from_reference(cut, cfg)
    extra = jax.tree.map(lambda a: a, npp)
    extra["embed"]["bias"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected.*bias"):
        params_from_reference(extra, cfg)
    bad = jax.tree.map(lambda a: a, npp)
    bad["blocks"]["pos0"]["attn"]["wq"] = \
        bad["blocks"]["pos0"]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq: shape"):
        params_from_reference(bad, cfg)
    wrong = jax.tree.map(lambda a: a, npp)
    wrong["embed"]["final_norm"] = wrong["embed"]["final_norm"] \
        .astype(np.float64)
    with pytest.raises(TypeError, match="final_norm: dtype"):
        params_from_reference(wrong, cfg)
    got = params_from_reference(npp, cfg, dtype=torch.bfloat16)
    assert got["embed"]["lm_head"].dtype == torch.bfloat16


# ------------------------------------------- the encdec family and int8
@pytest.mark.parametrize("name", OTHER)
def test_other_families_wait(name):
    """The encdec family builds (it waited for ROADMAP Queue A 12.3): the
    decoder units carry ``ln_cross``/``cross``, the encoder stack its own
    blocks and norm, and an encdec ``LMServer`` is refused, as the
    reference's ``generate`` takes no encoder embeddings."""
    cfg = configs.get_config(name).reduced()
    model = Model(cfg, torch.float32, device="cpu")
    params = make_params(cfg, layers.RealMaker(0))
    assert set(params) == {"embed", "blocks", "enc_blocks", "enc_norm"}
    assert {"ln_cross", "cross"} <= set(params["blocks"]["pos0"])
    assert params["enc_blocks"]["pos0"]["attn"]["wq"].shape[0] == \
        cfg.enc_layers
    with pytest.raises(ValueError, match="encdec"):
        LMServer(model, params, batch=B, max_len=8)


def test_int8_cache_and_cross_attention_wait(dense):
    """The int8 KV cache and cross-attention run (they waited for Queue A
    12.4 and 12.3): the int8 decode state's layout, a quantized token,
    cross-attention decode over a memory; and ``loss_fn`` (Queue A 12.5)
    gives a finite loss on the same params."""
    name, cfg, _, _, npp = dense
    model, tp = _port(name, npp, "torch")
    state = model.init_decode_state(B, 8, kv_quant=True)
    U, K = model.n_units, cfg.n_kv
    assert state["k"].dtype == state["v"].dtype == torch.int8
    assert tuple(state["k_scale"].shape) == (U, 1, B, 8, K)
    assert state["v_scale"].dtype == torch.float32
    x = torch.randn(B, 1, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    q, scale = attention.quantize_kv_token(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    p = {k: v[0] for k, v in tp["blocks"]["pos0"]["attn"].items()}
    mem_k, mem_v = attention.cross_memory_kv(p, x.expand(B, 5, -1),
                                             torch.float32)
    if K == cfg.n_heads:                     # cross-attention is full MHA
        out = attention.cross_attn_decode(p, x, cfg, mem_k, mem_v)
        assert out.shape == x.shape
    assert tuple(mem_k.shape) == (B, 5, K, cfg.head_dim)
    loss = model.loss_fn(tp, _tokens(cfg.vocab, (B, 4), 3))
    assert loss.shape == () and bool(torch.isfinite(loss))


def test_model_needs_a_card_unless_told_cpu():
    cfg = configs.get_config("smollm_360m").reduced()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
