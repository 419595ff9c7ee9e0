"""The moe, ssm and hybrid LM families of the port against the reference,
on reduced configs in f32 on the CPU: ``models/moe.py``,
``models/mamba.py``, ``Model`` over mixed units, the prefilled decode
state and ``LMServer``.  Weights are made by the reference
(``jax.random``) and carried across as numpy by ``models/convert.py``.
The mamba leaves the reference initialises to constants (``conv_x`` and
``A_log`` zero, ``dt_bias`` zero) are redrawn from a seed in the numpy
tree before both packages get it, so the SSD path does work that a
difference could show in.

Tolerances: f32 layers and logits rtol/atol 1e-4 (the same arithmetic in
another order); teacher-forced decode vs forward 2e-2 (the reference's,
``tests/test_models_smoke.py:92``); bf16 KV caches one bf16 step (1e-2);
greedy tokens equal.

The reference's ``LMServer`` cannot serve an f32 ssm or hybrid model: its
decode state holds ``conv`` in bf16, its ``ssm_decode_step`` returns the
window in f32, and the prefill's ``lax.scan`` rejects the changed carry
type.  ``_PromotedConv`` gives it the state its decode step produces from
the first step on, ``conv`` in f32 (ROADMAP Queue C).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.inference.server import LMServer as RefLMServer  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import mamba as ref_mamba  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.inference import LMServer  # noqa: E402
from repro_torch.models import layers, mamba, moe  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import Model, make_params  # noqa: E402

FAMILIES = ("moe", "ssm", "hybrid")
NAMES = [a for a in ref_configs.ARCH_IDS
         if ref_configs.get_config(a).family in FAMILIES]
BACKENDS = ["torch", "cuda"]
RTOL = ATOL = 1e-4
DECODE_TOL = 2e-2
SSD_CHUNK = 8
B = 2


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def _redraw_constants(tree, seed):
    """The mamba leaves the reference initialises to constants, redrawn
    from ``seed`` (numpy tree, in place order of the leaves)."""
    rng = np.random.default_rng(seed)

    def fix(path, a):
        if path[-1].key in ("conv_x", "A_log", "dt_bias"):
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(fix, tree)


class _PromotedConv(RefModel):
    """The reference model with its decode state's ``conv`` in the wider
    of the state and compute dtypes — what its ``ssm_decode_step``
    returns from the first step on (see the module docstring)."""

    def init_decode_state(self, *args, **kw):
        state = super().init_decode_state(*args, **kw)
        if "conv" in state:
            dt = jnp.promote_types(state["conv"].dtype, self.compute_dtype)
            state["conv"] = state["conv"].astype(dt)
        return state


def _ref_setup(name, **cfg_kw):
    cfg = dataclasses.replace(ref_configs.get_config(name).reduced(),
                              **cfg_kw)
    model = _PromotedConv(cfg, compute_dtype=jnp.float32, q_chunk=16,
                          ssd_chunk=SSD_CHUNK, remat=False)
    npp = _redraw_constants(jax.tree.map(
        np.asarray, model.init_params(jax.random.PRNGKey(0), jnp.float32)),
        seed=1)
    return cfg, model, jax.tree.map(jnp.asarray, npp), npp


@pytest.fixture(scope="module", params=NAMES)
def fam(request):
    """(name, reduced config, reference f32 model, reference params, the
    params as numpy, a cache of reference results)."""
    cfg, model, params, npp = _ref_setup(request.param)
    return request.param, cfg, model, params, npp, {}


def _port(name, npp, backend, **cfg_kw):
    cfg = dataclasses.replace(configs.get_config(name).reduced(), **cfg_kw)
    model = Model(cfg, torch.float32, q_chunk=16, ssd_chunk=SSD_CHUNK,
                  backend=backend, device="cpu")
    return model, params_from_reference(npp, cfg)


def _ref_generate(cache, model, params, prompts, n_new):
    key = ("generate", prompts.shape, n_new)
    if key not in cache:
        cache[key] = RefLMServer(model, params, batch=prompts.shape[0],
                                 max_len=prompts.shape[1] + n_new) \
            .generate(prompts, n_new)
    return cache[key]


# ----------------------------------------------------------------- params
def test_param_tree_matches_reference(fam):
    """Same leaves (the units' pos0..pos{k-1}), shapes and dtypes as the
    reference's tree; the seeded torch init fills it."""
    name, cfg, _, _, npp, _ = fam
    model = Model(cfg, torch.float32, backend="torch", device="cpu")
    ref = jax.tree_util.tree_flatten_with_path(npp)[0]
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), model.init_params(0)))[0]
    assert [k for k, _ in got] == [k for k, _ in ref]
    assert [v.shape for _, v in got] == [v.shape for _, v in ref]
    assert all(v.dtype == np.float32 for _, v in got)
    n = sum(int(np.prod(v.shape)) for _, v in got)
    assert abs(n - cfg.param_count()) / n < 0.02


def test_convert_carries_the_stacked_tree(fam):
    name, cfg, _, _, npp, _ = fam
    tp = params_from_reference(npp, cfg)
    for path, a in jax.tree_util.tree_flatten_with_path(npp)[0]:
        t = tp
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), a)
    bad = jax.tree.map(lambda a: a, npp)
    pos = next(p for p in bad["blocks"].values() if "moe" in p or "ssm" in p)
    sub = pos.get("moe") or pos.get("ssm")
    leaf = next(iter(sub))
    sub[leaf] = sub[leaf][:1]
    with pytest.raises(ValueError, match=f"{leaf}: shape"):
        params_from_reference(bad, cfg)


# -------------------------------------------------------------------- moe
def _moe_params(cfg, seed=4):
    mk = ref_layers.RealMaker(jax.random.PRNGKey(seed))
    ref_p = ref_moe.make_moe_params(mk, cfg)
    return ref_p, {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()}


# (B, S, group_size, capacity_factor, mlp): lossless small groups, one
# group over 256 tokens, capacity drops, two groups with drops, a ragged
# tail (B*S not a multiple of the group count), a ragged tail with drops,
# and the gelu expert
MOE_CASES = {
    "small": (2, 16, 1024, 1.25, "swiglu"),
    "capacity": (2, 320, 1024, 1.25, "swiglu"),
    "drops": (2, 320, 1024, 0.5, "swiglu"),
    "groups-drops": (2, 300, 300, 0.5, "swiglu"),
    "ragged": (2, 50, 30, 1.25, "swiglu"),
    "ragged-drops": (3, 201, 290, 0.5, "swiglu"),
    "gelu": (2, 320, 1024, 0.5, "gelu"),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_forward_matches_reference(case):
    Bc, S, gs, cf, mlp = MOE_CASES[case]
    cfg = dataclasses.replace(
        ref_configs.get_config("phi3.5-moe-42b-a6.6b").reduced(),
        capacity_factor=cf, mlp=mlp)
    ref_p, tp = _moe_params(cfg)
    x = np.random.default_rng(5).normal(size=(Bc, S, cfg.d_model)) \
        .astype(np.float32)
    want, want_aux = ref_moe.moe_forward(ref_p, jnp.asarray(x), cfg,
                                         group_size=gs)
    got, aux = moe.moe_forward(tp, torch.from_numpy(x), cfg, group_size=gs)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=RTOL,
                               atol=ATOL)
    n_tok = Bc * S
    g = max(1, n_tok // gs) if n_tok >= gs else 1
    if g * (n_tok // g) < n_tok:                     # the tail's output is 0
        assert not got.reshape(n_tok, -1)[g * (n_tok // g):].any()
    if "drops" in case or case == "gelu":
        sg = n_tok // g
        logits = torch.from_numpy(x).reshape(n_tok, -1)[:g * sg] \
            .reshape(g, sg, -1) @ tp["router"]
        cap = int(cfg.top_k * sg / cfg.n_experts * cf)
        _, _, keep = moe.route(torch.softmax(logits, -1), cfg.top_k, cap)
        assert not keep.all()                         # capacity bites


def test_moe_lossless_routes_every_token():
    """``lossless=True`` (the one-pass prefill) equals the reference
    routing the same tokens in groups of at most 256 — its decode steps —
    and differs from the capacity-limited forward where that drops."""
    cfg = dataclasses.replace(
        ref_configs.get_config("phi3.5-moe-42b-a6.6b").reduced(),
        capacity_factor=0.5)
    ref_p, tp = _moe_params(cfg)
    x = np.random.default_rng(6).normal(size=(2, 320, cfg.d_model)) \
        .astype(np.float32)
    want = np.concatenate(
        [_np(ref_moe.moe_forward(ref_p, jnp.asarray(x[:, s:s + 64]),
                                 cfg)[0]) for s in range(0, 320, 64)],
        axis=1)
    got, _ = moe.moe_forward(tp, torch.from_numpy(x), cfg, lossless=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    capped, _ = moe.moe_forward(tp, torch.from_numpy(x), cfg)
    assert not torch.allclose(capped, got, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ mamba
def _ssd_inputs(S, seed=7, Bc=2, H=8, P=16, G=2, N=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    xh, Bm, Cm = f(Bc, S, H, P), f(Bc, S, G, N), f(Bc, S, G, N)
    dt = np.log1p(np.exp(f(Bc, S, H)))                     # softplus > 0
    A = -np.exp(0.5 * f(H))
    h0 = f(Bc, H, P, N)
    return xh, dt, A, Bm, Cm, h0


@pytest.mark.parametrize("h0", [False, True])
def test_ssd_chunked_matches_reference(h0):
    xh, dt, A, Bm, Cm, h = _ssd_inputs(32)
    h = h if h0 else None
    want_y, want_h = ref_mamba.ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), chunk=8,
        h0=None if h is None else jnp.asarray(h))
    got_y, got_h = mamba.ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)), chunk=8,
        h0=None if h is None else torch.from_numpy(h))
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), rtol=RTOL,
                               atol=ATOL)


def test_ssd_chunked_takes_a_short_last_chunk():
    """S = 20 in chunks of 8 (8, 8, 4) against the reference's chunks of
    4, which divide 20: the chunking changes only the summation order."""
    xh, dt, A, Bm, Cm, h = _ssd_inputs(20)
    want_y, want_h = ref_mamba.ssd_chunked(
        *(jnp.asarray(a) for a in (xh, dt, A, Bm, Cm)), chunk=4,
        h0=jnp.asarray(h))
    got_y, got_h = mamba.ssd_chunked(
        *(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)), chunk=8,
        h0=torch.from_numpy(h))
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_h.numpy(), _np(want_h), rtol=RTOL,
                               atol=ATOL)


def _ssm_params(cfg, seed=8):
    mk = ref_layers.RealMaker(jax.random.PRNGKey(seed))
    ref_p = {k: np.asarray(v) for k, v in
             ref_mamba.make_ssm_params(mk, cfg).items()}
    ref_p = _redraw_constants({"ssm": ref_p}, seed)["ssm"]
    return ({k: jnp.asarray(v) for k, v in ref_p.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in ref_p.items()})


@pytest.mark.parametrize("name", ["mamba2-370m", "jamba-1.5-large-398b"])
def test_ssm_forward_and_decode_step_match_reference(name):
    cfg = ref_configs.get_config(name).reduced()
    ref_p, tp = _ssm_params(cfg)
    x = np.random.default_rng(9).normal(size=(B, 16, cfg.d_model)) \
        .astype(np.float32)
    want = ref_mamba.ssm_forward(ref_p, jnp.asarray(x), cfg, chunk=8)
    got = mamba.ssm_forward(tp, torch.from_numpy(x), cfg, chunk=8)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL, atol=ATOL)
    # five recurrent steps from the zero state, then the one-pass state
    st = ref_mamba.init_ssm_state(cfg, B, 1)
    h, conv = st["h"][0], st["conv"][0]
    th, tconv = (torch.from_numpy(np.array(a)) for a in (h, conv))
    for i in range(5):
        want, h, conv = ref_mamba.ssm_decode_step(
            ref_p, jnp.asarray(x[:, i:i + 1]), cfg, h, conv)
        got, th, tconv = mamba.ssm_decode_step(
            tp, torch.from_numpy(x[:, i:i + 1]), cfg, th, tconv)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(th.numpy(), _np(h), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(tconv.numpy(), _np(conv), rtol=RTOL,
                                   atol=ATOL)
    out, hf, cv = mamba.ssm_forward(tp, torch.from_numpy(x[:, :5]), cfg,
                                    chunk=2, state_dtype=torch.float32)
    np.testing.assert_allclose(hf.numpy(), _np(h), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(cv.numpy(), _np(conv), rtol=RTOL, atol=ATOL)


# ------------------------------------------------------------------ model
@pytest.mark.parametrize("backend", BACKENDS)
def test_model_forward_and_prefill(fam, backend):
    name, cfg, ref_model, params, npp, cache = fam
    model, tp = _port(name, npp, backend)
    toks = _tokens(cfg.vocab, (B, 32), seed=5)
    if "forward" not in cache:
        cache["forward"] = _np(ref_model.forward(params, jnp.asarray(toks)))
        cache["prefill"] = _np(ref_model.prefill(params, jnp.asarray(toks)))
    got = model.forward(tp, toks)
    assert got.shape == (B, 32, cfg.vocab)
    np.testing.assert_allclose(got.numpy(), cache["forward"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(model.prefill(tp, toks).numpy(),
                               cache["prefill"], rtol=RTOL, atol=ATOL)


def test_decode_matches_forward(fam):
    """tests/test_models_smoke.py:67-92 on the port: teacher-forced decode
    steps reproduce the forward logits (f32 model, f32 state)."""
    name, cfg, _, _, npp, _ = fam
    model, tp = _port(name, npp, "cuda")
    toks = _tokens(cfg.vocab, (B, 8), seed=2)
    full = model.forward(tp, toks).numpy()
    state = model.init_decode_state(B, 9, dtype=torch.float32)
    got = []
    for i in range(8):
        logits, state = model.decode_step(tp, state, toks[:, i:i + 1])
        got.append(logits.numpy())
    assert state["index"] == 8
    np.testing.assert_allclose(np.stack(got, axis=1), full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_decode_state_layout(fam):
    """The reference's shapes per unit: na attention caches, ns mamba
    states; ``conv`` in the promoted dtype, ``ssm_h`` f32."""
    name, cfg, ref_model, _, npp, _ = fam
    model, _ = _port(name, npp, "torch")
    want = ref_model.init_decode_state(B, 12)
    got = model.init_decode_state(B, 12)
    assert set(got) == set(want)
    for k in want:
        if k == "index":
            continue
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


# S = 13: not a multiple of the SSD chunk; S = 2: shorter than the conv
# window (cw - 1 = 3), so the prefilled window is left-padded with zeros
@pytest.mark.parametrize("S", [13, 2])
@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_state_matches_sequential_prefill(fam, backend, S):
    """The one-pass prefill against the reference ``LMServer._prefill`` (S
    teacher-forced decode steps): index, last logits, bf16 KV caches,
    f32 SSD states and conv windows."""
    name, cfg, ref_model, params, npp, cache = fam
    model, tp = _port(name, npp, backend)
    prompts = _tokens(cfg.vocab, (B, S), seed=6)
    key = ("prefill", S)
    if key not in cache:
        ref = RefLMServer(ref_model, params, batch=B, max_len=20)
        cache[key] = ref._prefill(params, ref_model.init_decode_state(B, 20),
                                  jnp.asarray(prompts))
    ref_state, ref_logits = cache[key]
    server = LMServer(model, tp, batch=B, max_len=20)
    state, logits = server._prefill(model.init_decode_state(B, 20), prompts)
    assert state["index"] == int(ref_state["index"]) == S
    np.testing.assert_allclose(logits.numpy(), _np(ref_logits), rtol=RTOL,
                               atol=ATOL)
    for k in ("k", "v"):
        if k in ref_state:
            assert state[k].dtype == torch.bfloat16
            np.testing.assert_allclose(state[k].float().numpy(),
                                       _np(ref_state[k]), rtol=1e-2,
                                       atol=1e-2)
            assert not state[k][:, :, :, S:].any()
    for k in ("ssm_h", "conv"):
        if k in ref_state:
            assert state[k].dtype == torch.float32
            np.testing.assert_allclose(state[k].numpy(), _np(ref_state[k]),
                                       rtol=RTOL, atol=ATOL)
    assert ("ssm_h" in state) == (cfg.family != "moe")


@pytest.mark.parametrize("backend", BACKENDS)
def test_lmserver_generate_matches_reference(fam, backend):
    """B·S = 260 prompt tokens: past 256, where one pass over the prompt
    would route by capacity; the server routes every token, as the
    reference's decode steps do."""
    name, cfg, ref_model, params, npp, cache = fam
    model, tp = _port(name, npp, backend)
    prompts = _tokens(cfg.vocab, (B, 130), seed=7)
    want = _ref_generate(cache, ref_model, params, prompts, 6)
    server = LMServer(model, tp, batch=B, max_len=136)
    got = server.generate(prompts, 6)
    assert got.dtype == np.int32 and got.shape == (B, 136)
    np.testing.assert_array_equal(got, want)
    assert server.last_times["n_decode"] == 6


@pytest.mark.parametrize("name", [n for n in NAMES
                                  if ref_configs.get_config(n).n_experts])
def test_lmserver_prefill_routes_every_token(name):
    """At capacity factor 0.5 the one-pass forward drops tokens: the
    server's prefill still gives the reference ``LMServer``'s tokens."""
    cfg, ref_model, params, npp = _ref_setup(name, capacity_factor=0.5)
    model, tp = _port(name, npp, "torch", capacity_factor=0.5)
    prompts = _tokens(cfg.vocab, (B, 140), seed=8)
    want = RefLMServer(ref_model, params, batch=B,
                       max_len=144).generate(prompts, 4)
    server = LMServer(model, tp, batch=B, max_len=144)
    np.testing.assert_array_equal(server.generate(prompts, 4), want)
    state = model.init_decode_state(B, 144)
    lossless = model.prefill(tp, prompts, state)
    assert not torch.allclose(model.prefill(tp, prompts), lossless,
                              rtol=RTOL, atol=ATOL)


# ------------------------------------- the encdec family and int8 cache
def test_encdec_and_int8_cache_still_raise(fam):
    """What raised before Queue A 12.3 and 12.4 now runs: the encdec
    model builds (``LMServer`` refuses it, as the reference's cannot take
    encoder embeddings), and ``LMServer(kv_quant=True)`` serves this
    family with an int8 cache and f32 scales per attention layer — a
    mamba-only model has none and ignores ``kv_quant``, as the
    reference's does; ``tests/test_torch_kv_quant.py`` holds the tokens.
    """
    name, cfg, _, _, npp, _ = fam
    enc = configs.get_config("seamless-m4t-large-v2").reduced()
    enc_model = Model(enc, torch.float32, device="cpu")
    enc_params = make_params(enc, layers.RealMaker(0))
    with pytest.raises(ValueError, match="encdec"):
        LMServer(enc_model, enc_params, batch=B, max_len=8)
    model, tp = _port(name, npp, "torch")
    server = LMServer(model, tp, batch=B, max_len=12, kv_quant=True)
    prompts = _tokens(cfg.vocab, (B, 4), seed=3)
    out = server.generate(prompts, 4)
    assert out.shape == (B, 8) and np.array_equal(out[:, :4], prompts)
    state = model.init_decode_state(B, 8, kv_quant=True)
    na, _ = model.mixer_counts()
    assert ("k_scale" in state) == (na > 0)
    if na:
        assert state["k"].dtype == torch.int8
        assert tuple(state["v_scale"].shape) == (model.n_units, na, B, 8,
                                                 cfg.n_kv)
