"""The port's training loss against the reference on the CPU:
``Model.loss_fn`` and its gradients for one reduced config of each family
(dense smollm-360m, moe phi3.5-moe, ssm mamba2-370m, hybrid jamba,
encdec seamless-m4t-large-v2) against ``jax.value_and_grad`` of the
reference's ``Model.loss_fn``, the chunked flash's gradient through its
causal chunk loop, and the guard that keeps the card's flash kernel (which
has no backward pass) out of autograd.

Weights are made by the reference (``jax.random``), the mamba constants
(``conv_x``, ``A_log``, ``dt_bias``) redrawn from a seed so the SSD path
does work a gradient could show, and carried across as numpy by
``models/convert.py``; tokens and encoder frames are numpy from a seed.

Tolerances: in f32 the loss agrees to rtol 1e-5 and each gradient leaf to
``GRAD_TOL`` of its largest |entry| (the same arithmetic, summed in another
order; measured ~1e-6).  In bf16 both packages round every product to bf16
in their own order: the loss within 1e-2 relative, each leaf within 5% of
its largest |entry|.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.kernels.flash_attention_kernel import (  # noqa: E402
    flash_forward)
from repro_torch.models import attention  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import (Model, tree_flatten,  # noqa: E402
                                      tree_unflatten)

FAMILIES = {"dense": "smollm_360m", "moe": "phi3_5_moe_42b",
            "ssm": "mamba2_370m", "hybrid": "jamba_1_5_large_398b",
            "encdec": "seamless_m4t_large_v2"}
B, S, S_ENC = 2, 32, 16
Q_CHUNK, SSD_CHUNK, LOSS_CHUNK = 16, 8, 16
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-2, 5e-2


def _redraw_constants(tree, seed):
    rng = np.random.default_rng(seed)

    def fix(path, a):
        if path[-1].key in ("conv_x", "A_log", "dt_bias"):
            return rng.normal(0, 0.5, a.shape).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(fix, tree)


def _inputs(cfg, seed=0, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, size=(batch, seq)).astype(np.int32)
    enc = None
    if cfg.family == "encdec":
        enc = rng.normal(0, 1, size=(batch, S_ENC, cfg.d_model)) \
            .astype(np.float32)
    return tokens, enc


@pytest.fixture(scope="module")
def ref_cache():
    return {}


def _reference(cache, name, dtype=jnp.float32, batch=B, seq=S, **cfg_kw):
    """(params as numpy, tokens, enc, reference loss, reference grads as a
    list in jax.tree.flatten's order), computed once per case."""
    key = (name, dtype, batch, seq, tuple(sorted(cfg_kw.items())))
    if key not in cache:
        cfg = dataclasses.replace(ref_configs.get_config(name).reduced(),
                                  **cfg_kw)
        model = RefModel(cfg, compute_dtype=dtype, q_chunk=Q_CHUNK,
                         ssd_chunk=SSD_CHUNK, loss_chunk=LOSS_CHUNK,
                         remat=False)
        npp = _redraw_constants(jax.tree.map(
            np.asarray, model.init_params(jax.random.PRNGKey(0),
                                          jnp.float32)), seed=1)
        tokens, enc = _inputs(cfg, batch=batch, seq=seq)
        args = (jnp.asarray(tokens),) + (
            () if enc is None else (jnp.asarray(enc),))
        loss, grads = jax.jit(jax.value_and_grad(model.loss_fn))(
            jax.tree.map(jnp.asarray, npp), *args)
        cache[key] = (npp, tokens, enc, float(loss),
                      [np.asarray(g, np.float32)
                       for g in jax.tree.leaves(grads)])
    return cache[key]


def _port_loss_and_grads(name, npp, tokens, enc, dtype=torch.float32,
                         cfg_kw=None, **model_kw):
    cfg = dataclasses.replace(configs.get_config(name).reduced(),
                              **(cfg_kw or {}))
    kw = dict(q_chunk=Q_CHUNK, ssd_chunk=SSD_CHUNK, loss_chunk=LOSS_CHUNK,
              remat=False)
    kw.update(model_kw)
    model = Model(cfg, dtype, backend="torch", device="cpu", **kw)
    leaves, treedef = tree_flatten(params_from_reference(npp, cfg))
    for p in leaves:
        p.requires_grad_(True)
    loss = model.loss_fn(tree_unflatten(treedef, leaves), tokens,
                         None if enc is None else torch.from_numpy(enc))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


def _assert_grads_close(got, ref, tol):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        scale = float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol * scale + 1e-12,
                                   err_msg=f"gradient leaf {i}")


# ---------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_reference(ref_cache, family, remat):
    """f32, ``loss_chunk`` 16 < S 32 (two loss chunks), with and without
    recomputation: the loss and every gradient leaf."""
    name = FAMILIES[family]
    npp, tokens, enc, ref_loss, ref_grads = _reference(ref_cache, name)
    loss, grads = _port_loss_and_grads(name, npp, tokens, enc, remat=remat)
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    _assert_grads_close(grads, ref_grads, GRAD_TOL)
    cfg = configs.get_config(name)
    # near ln(vocab) at init (tests/test_models_smoke.py:51)
    assert 0.2 * np.log(cfg.reduced().vocab) < loss \
        < 3.0 * np.log(cfg.reduced().vocab)


@pytest.mark.parametrize("loss_chunk", [8, S])
def test_loss_chunk_does_not_change_the_loss(ref_cache, loss_chunk):
    """Four chunks or one whole chunk give the reference's loss and
    gradients (computed with two)."""
    name = FAMILIES["dense"]
    npp, tokens, enc, ref_loss, ref_grads = _reference(ref_cache, name)
    loss, grads = _port_loss_and_grads(name, npp, tokens, enc,
                                       loss_chunk=loss_chunk, remat=True)
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    _assert_grads_close(grads, ref_grads, GRAD_TOL)


def test_loss_and_grads_match_reference_bf16(ref_cache):
    """The trainer's compute dtype: bf16 products on both sides, f32
    masters."""
    name = FAMILIES["dense"]
    npp, tokens, enc, ref_loss, ref_grads = _reference(
        ref_cache, name, dtype=jnp.bfloat16)
    loss, grads = _port_loss_and_grads(name, npp, tokens, enc,
                                       dtype=torch.bfloat16, remat=True)
    assert loss == pytest.approx(ref_loss, rel=BF16_LOSS_RTOL)
    _assert_grads_close(grads, ref_grads, BF16_GRAD_TOL)


def test_moe_loss_with_capacity_drops_matches_reference(ref_cache):
    """384 tokens in one group (> 256) and capacity factor 0.5: each of the
    4 experts keeps at most 96 of the 768 (token, choice) pairs, so pairs
    are dropped, and the gradient must flow only through the kept ones, as
    through the reference's one-hot dispatch."""
    name = FAMILIES["moe"]
    npp, tokens, enc, ref_loss, ref_grads = _reference(
        ref_cache, name, batch=4, seq=96, capacity_factor=0.5)
    loss, grads = _port_loss_and_grads(name, npp, tokens, enc,
                                       cfg_kw=dict(capacity_factor=0.5))
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    _assert_grads_close(grads, ref_grads, GRAD_TOL)


def test_loss_fn_refuses_a_ragged_last_chunk():
    cfg = configs.get_config("smollm_360m").reduced()
    model = Model(cfg, torch.float32, loss_chunk=12, backend="torch",
                  device="cpu")
    with pytest.raises(ValueError, match="loss_chunk"):
        model.loss_fn(model.init_params(0), np.zeros((1, 32), np.int32))


# ----------------------------------------------------- chunk-loop gradient
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_gradient_through_the_chunk_loop(causal):
    """q and k chunks of 8 over S 32: the port skips the key chunks wholly
    above the diagonal, where the reference adds them with weight 0 and a
    correction of exactly 1; both give zero gradient there, so q, k and v
    get the same gradients (GQA 4/2)."""
    rng = np.random.default_rng(5)
    q, k, v, w = (rng.normal(0, 1, shape).astype(np.float32) for shape in
                  ((2, 32, 4, 8), (2, 32, 2, 8), (2, 32, 2, 8),
                   (2, 32, 4, 8)))

    def ref_fn(q, k, v):
        out = ref_attn.flash_attention(q, k, v, causal=causal, q_chunk=8,
                                       k_chunk=8, n_rep=2)
        return jnp.sum(out * w)
    ref = jax.grad(ref_fn, argnums=(0, 1, 2))(q, k, v)
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = attention.flash_attention(*ts, causal=causal, q_chunk=8,
                                    k_chunk=8, n_rep=2)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), ts)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    if causal:                          # the last key row: one query sees it
        assert float(got[1][:, -1].abs().sum()) > 0


# -------------------------------------------------------- the autograd guard
def test_cuda_backend_loss_fn_raises_under_autograd():
    """``backend="cuda"`` runs the flash kernel (its plain version on the
    CPU), which has no backward: under autograd ``loss_fn`` raises on both
    devices rather than return a loss whose gradient lacks the attention
    path.  Without grad it computes the torch backend's loss."""
    cfg = configs.get_config("smollm_360m").reduced()
    model = Model(cfg, torch.float32, q_chunk=Q_CHUNK, loss_chunk=16,
                  remat=False, backend="cuda", device="cpu")
    params = model.init_params(0)
    tokens, _ = _inputs(cfg)
    leaves, treedef = tree_flatten(params)
    for p in leaves:
        p.requires_grad_(True)
    before = flash_forward.launches
    with pytest.raises(RuntimeError, match='backend="torch"'):
        model.loss_fn(tree_unflatten(treedef, leaves), tokens)
    with torch.no_grad():
        loss = model.loss_fn(params, tokens)
        ref = Model(cfg, torch.float32, q_chunk=Q_CHUNK, loss_chunk=16,
                    backend="torch", device="cpu").loss_fn(params, tokens)
    assert float(loss) == pytest.approx(float(ref), rel=1e-5)
    assert flash_forward.launches == before      # plain versions only


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_forward_refuses_inputs_that_require_grad(which):
    q, k, v = (torch.randn(4, 16, 8) for _ in range(3))
    [q, k, v][which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_forward(q, k, v, n_rep=1)
    with torch.no_grad():
        assert flash_forward(q, k, v, n_rep=1).shape == q.shape
