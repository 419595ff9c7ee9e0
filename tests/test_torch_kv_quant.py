"""The port's int8 KV cache against the reference (``tests/test_kv_quant.py``
on both packages), in f32 on the CPU: ``quantize_kv_token`` bit for bit,
``attn_decode_step`` with scales, int8 decode against the f32-cache
decode, ``LMServer(kv_quant=True)`` and the decode state's bytes.
Weights are made by the reference (``jax.random``) and carried across as
numpy by ``models/convert.py``; jamba's mamba constants are redrawn from a
seed and the reference gets an f32 ``conv`` state, as in
``tests/test_torch_lm_families.py``.

Tolerances: quantized values and scales exact; int8 decode steps rtol/atol
1e-4 against the reference's (the same arithmetic, the bf16 roundings
included, in another order); int8 against f32-cache decode the
reference's rtol/atol 0.05 with the same argmax.  The one-pass int8
prefill attends over the dequantized k̂·scale and v̂·scale in the compute
dtype, where the reference's decode steps round w·v_scale to bf16 (a
relative error up to 2^-9 per weight): its last logits are held within
one bf16 step, 2^-8 of the largest |logit|, of the reference's
sequential prefill, and its int8 values within one quantization step.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.inference.server import LMServer as RefLMServer  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.inference import LMServer  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from test_torch_lm_families import (_PromotedConv,  # noqa: E402
                                    _redraw_constants)

ARCHS = ["smollm_360m", "phi3_mini_3_8b", "jamba_1_5_large_398b"]
BACKENDS = ["torch", "cuda"]
RTOL = ATOL = 1e-4
TRACK_TOL = 0.05                 # tests/test_kv_quant.py:53
PREFILL_REL = 2.0 ** -8          # one bf16 step of the largest |logit|
B = 2


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(name, reduced config, reference f32 model, reference params, the
    params as numpy, a cache of reference results)."""
    cfg = ref_configs.get_config(request.param).reduced()
    model = _PromotedConv(cfg, compute_dtype=jnp.float32, q_chunk=16,
                          ssd_chunk=8, remat=False)
    npp = _redraw_constants(jax.tree.map(
        np.asarray, model.init_params(jax.random.PRNGKey(0), jnp.float32)),
        seed=1)
    return (request.param, cfg, model, jax.tree.map(jnp.asarray, npp), npp,
            {})


def _port(name, npp, backend):
    cfg = configs.get_config(name).reduced()
    model = Model(cfg, torch.float32, q_chunk=16, ssd_chunk=8,
                  backend=backend, device="cpu")
    return model, params_from_reference(npp, cfg)


# --------------------------------------------------------------- quantize
def _quant_rows():
    """(B, S, K, hd) rows: random at three scales, zeros (the 1e-8 floor),
    amax 127 with ties at .5 (scale exactly 1: round half to even) and
    -127 at the clip, and a row below the floor."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, size=(2, 3, 4, 16)).astype(np.float32)
    x[0, 1] *= 1e-3
    x[1, 2] *= 1e3
    x[0, 0, 1] = 0.0
    x[0, 0, 2] = [127.0, -127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5,
                  -126.5, 63.5, 0.0, 1.0, -2.5, 4.5, 5.5, -6.5]
    x[1, 0, 3] = rng.normal(0, 1e-10, size=16)
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_token_is_bit_exact(dtype):
    x = _quant_rows()
    want_q, want_s = ref_attn.quantize_kv_token(jnp.asarray(x, dtype))
    got_q, got_s = attention.quantize_kv_token(
        torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == x.shape[:-1]
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    if dtype == "float32":
        assert got_q[0, 0, 2, :10].tolist() == [127, -127, 2, -4, 0, 0, 2,
                                                126, -126, 64]
        assert not got_q[0, 0, 1].any()
        assert float(got_s[0, 0, 1]) == np.float32(1e-8) / np.float32(127)


def test_quantize_kv_token_round_trip():
    """tests/test_kv_quant.py:16-24 on the port: dequantized within half a
    step of x."""
    x = np.random.default_rng(0).normal(0, 3, size=(2, 1, 4, 16)) \
        .astype(np.float32)
    q, scale = attention.quantize_kv_token(torch.from_numpy(x))
    err = (q.float() * scale[..., None] - torch.from_numpy(x)).abs()
    assert bool((err <= scale[..., None] * 0.51 + 1e-7).all())


# ------------------------------------------------------------ decode step
def test_attn_decode_step_with_scales_matches_reference(arch):
    """One int8 decode step over a cache holding 9 positions: the output,
    the int8 caches and the scales with the new token written at
    ``index``."""
    name, cfg, _, params, npp, _ = arch
    ai = next(i for i in range(len(params["blocks"]))
              if "attn" in params["blocks"][f"pos{i}"])
    p = jax.tree.map(lambda a: a[0], params["blocks"][f"pos{ai}"]["attn"])
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    rng = np.random.default_rng(4)
    Smax, index = 16, 9
    shape = (B, Smax, cfg.n_kv, cfg.head_dim)
    kc, vc = (rng.integers(-127, 128, size=shape).astype(np.int8)
              for _ in range(2))
    ks, vs = (rng.uniform(0.001, 0.05, size=shape[:-1]).astype(np.float32)
              for _ in range(2))
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    want = ref_attn.attn_decode_step(
        p, jnp.asarray(x), cfg, jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(index, jnp.int32), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = attention.attn_decode_step(
        tp, torch.from_numpy(x), cfg, *(torch.from_numpy(a.copy())
                                        for a in (kc, vc)), index,
        k_scale=torch.from_numpy(ks.copy()),
        v_scale=torch.from_numpy(vs.copy()))
    assert len(got) == 5
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=RTOL,
                               atol=ATOL)
    for g, w in zip(got[1:3], want[1:3]):
        assert g.dtype == torch.int8
        assert np.abs(g.numpy().astype(int) - np.asarray(w)).max() <= 1
        np.testing.assert_array_equal(np.delete(g.numpy(), index, axis=1),
                                      np.delete(np.asarray(w), index, 1))
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_allclose(g.numpy(), _np(w), rtol=RTOL, atol=0)
    with pytest.raises(ValueError, match="go together"):
        attention.attn_decode_step(tp, torch.from_numpy(x), cfg,
                                   torch.from_numpy(kc.copy()),
                                   torch.from_numpy(vc.copy()), index,
                                   k_scale=torch.from_numpy(ks.copy()))


def _decode(model, params, toks, kv_quant, step, dtype=torch.float32):
    state = model.init_decode_state(B, toks.shape[1] + 1, dtype=dtype,
                                    kv_quant=kv_quant)
    outs = []
    for i in range(toks.shape[1]):
        logits, state = step(params, state, toks[:, i:i + 1])
        outs.append(np.asarray(logits))
    return np.stack(outs, axis=1), state


def test_int8_kv_decode_tracks_f32(arch):
    """tests/test_kv_quant.py:27-55 on the port: the int8-cache decode
    tracks the f32-cache decode (0.05, same argmax), and equals the
    reference's int8 decode step by step at 1e-4."""
    name, cfg, ref_model, params, npp, cache = arch
    model, tp = _port(name, npp, "torch")
    toks = _tokens(cfg.vocab, (B, 8), seed=1)
    base, _ = _decode(model, tp, toks, False, model.decode_step)
    quant, state = _decode(model, tp, toks, True, model.decode_step)
    if "k" in state:
        assert state["k"].dtype == torch.int8
        assert state["k_scale"].dtype == torch.float32
    np.testing.assert_allclose(quant, base, rtol=TRACK_TOL, atol=TRACK_TOL)
    np.testing.assert_array_equal(quant.argmax(-1), base.argmax(-1))
    if "decode" not in cache:
        cache["decode"] = _decode(ref_model, params, toks, True,
                                  jax.jit(ref_model.decode_step),
                                  jnp.float32)[0]
    np.testing.assert_allclose(quant, cache["decode"], rtol=RTOL, atol=ATOL)


# ----------------------------------------------------------------- server
@pytest.mark.parametrize("backend", BACKENDS)
def test_lmserver_kv_quant_matches_reference(arch, backend):
    """``LMServer(kv_quant=True)`` greedy tokens equal the reference
    ``LMServer(kv_quant=True)``'s; the one-pass int8 prefill's state and
    last logits against the reference's sequential int8 prefill (module
    docstring: one bf16 step of the largest |logit|, int8 values within
    one step, the first attention layer's values equal)."""
    name, cfg, ref_model, params, npp, cache = arch
    model, tp = _port(name, npp, backend)
    prompts = _tokens(cfg.vocab, (B, 13), seed=7)
    if "served" not in cache:
        ref = RefLMServer(ref_model, params, batch=B, max_len=20,
                          kv_quant=True)
        cache["served"] = (
            ref.generate(prompts, 6),
            ref._prefill(params, ref_model.init_decode_state(
                B, 20, kv_quant=True), jnp.asarray(prompts)))
    want, (ref_state, ref_logits) = cache["served"]
    server = LMServer(model, tp, batch=B, max_len=20, kv_quant=True)
    np.testing.assert_array_equal(server.generate(prompts, 6), want)
    state, logits = server._prefill(
        model.init_decode_state(B, 20, kv_quant=True), prompts)
    assert state["index"] == 13
    ref_logits = _np(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=0,
                               atol=PREFILL_REL * np.abs(ref_logits).max())
    for k in ("k", "v"):
        got, ref_k = state[k].numpy().astype(int), np.asarray(ref_state[k])
        assert state[k].dtype == torch.int8
        assert np.abs(got - ref_k).max() <= 1
        np.testing.assert_array_equal(got[0, 0], ref_k[0, 0])
        assert not got[:, :, :, 13:].any()
        np.testing.assert_allclose(state[k + "_scale"].numpy(),
                                   _np(ref_state[k + "_scale"]),
                                   rtol=PREFILL_REL, atol=0)


def test_kv_quant_state_bytes_halved(arch):
    """tests/test_kv_quant.py:75-91 on the port: int8 + an f32 scale per
    head, (1 + 4/hd) bytes against bf16's 2 (hd 16: 0.625)."""
    name, _, _, _, npp, _ = arch
    model, _ = _port(name, npp, "torch")

    def nbytes(state, keys=None):
        return sum(t.numel() * t.element_size() for k, t in state.items()
                   if isinstance(t, torch.Tensor) and k in (keys or state))
    s_bf16 = model.init_decode_state(4, 64)
    s_int8 = model.init_decode_state(4, 64, kv_quant=True)
    assert set(s_int8) == set(s_bf16) | {"k_scale", "v_scale"}
    if name != "jamba_1_5_large_398b":        # the mamba states stay
        assert nbytes(s_int8) < 0.65 * nbytes(s_bf16)
    assert nbytes(s_int8, ("k", "v", "k_scale", "v_scale")) \
        < 0.65 * nbytes(s_bf16, ("k", "v"))
