"""The port's training substrate against the reference on the CPU:
``distributed/compression.py``, ``distributed/optimizer.py``,
``distributed/checkpoint.py`` (with its msgpack codec),
``distributed/fault_tolerance.py`` and ``models.model.tree_flatten``.
Inputs are numpy from a seed; both packages get the same arrays.

Tolerances: the int8 codec is elementwise IEEE f32 (a sum, an amax, a
division, a round half to even), so ``compress`` and ``compress_tree``
must be bit-exact.  Adam's f32 update matches to rtol 1e-6 / atol 1e-7:
the bias corrections are an f32 ``pow`` whose last bit XLA and torch may
round apart.  Through that, an int8 moment may round one step apart (at
most 1 in q) where the reference's quotient sits at a half.  Checkpoints
and their manifests must match byte for byte.  The remaining cases are
the reference's own ``tests/test_distributed.py`` cases run on the port,
with its tolerances.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402
import numpy as np  # noqa: E402

from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import optimizer as ref_opt  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed import compression as comp  # noqa: E402
from repro_torch.distributed import optimizer as opt  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    Heartbeat, PreemptionFlag, StragglerDetector, plan_elastic_restart)
from repro_torch.models.model import tree_flatten, tree_unflatten  # noqa: E402

ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-7
SHAPES = [(), (7,), (3, 5), (2, 4, 6)]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand_tree(seed, scale=1.0):
    """A params-like tree of f32 leaves (a 0-d leaf, rows of mixed scale
    and a row of zeros), as numpy."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, scale, (4, 6)).astype(np.float32)
    w[1] *= 1e-4                                     # a small row
    w[2] = 0.0                                       # an all-zero row
    return {"b": {"c": rng.normal(0, scale, (5,)).astype(np.float32),
                  "a": np.float32(rng.normal(0, scale))},
            "w": w,
            "u": rng.normal(0, scale, (2, 3, 4)).astype(np.float32)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


# --------------------------------------------------------------- tree order
def test_tree_flatten_order_matches_jax():
    tree = _rand_tree(0)
    tree["m"] = {"q": np.zeros(3, np.int8), "scale": np.ones(1, np.float32)}
    ref_leaves, ref_td = jax.tree.flatten(tree)
    leaves, td = tree_flatten(tree)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(ref_leaves, leaves):
        assert a is b
    assert ckpt.treedef_string(td) == str(ref_td)
    back = tree_unflatten(td, leaves)
    assert jax.tree.structure(back) == ref_td
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(td, leaves + [1])
    # an is_leaf dict is one leaf
    got, _ = tree_flatten(tree, is_leaf=opt.is_q8)
    assert sum(isinstance(x, dict) for x in got) == 1


# -------------------------------------------------------------- compression
@pytest.mark.parametrize("shape", SHAPES)
def test_compress_bit_exact(shape):
    rng = np.random.default_rng(len(shape))
    g = rng.normal(0, 1, shape).astype(np.float32)
    r = rng.normal(0, 1e-2, shape).astype(np.float32)
    # quotients on a tie: x / scale = k + 0.5 exactly (scale 1/127 · amax)
    if g.ndim:
        g.reshape(-1)[:2] = [1.0, 0.5 / 127.0 * 1.0]
        r.reshape(-1)[:2] = 0.0
    ref = ref_comp.compress(jnp.asarray(g), jnp.asarray(r))
    got = comp.compress(torch.from_numpy(g), torch.from_numpy(r))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    assert got[0].dtype == torch.int8
    np.testing.assert_array_equal(
        _np(comp.decompress(got[0], got[1])),
        np.asarray(ref_comp.decompress(ref[0], ref[1])))


def test_compress_tree_with_residuals_bit_exact_over_steps():
    """Error feedback over 4 steps: the dequantized grads and the carried
    residuals equal the reference's at every step."""
    r_ref = ref_comp.init_residuals(_to_jax(_rand_tree(0)))
    r_got = comp.init_residuals(_to_torch(_rand_tree(0)))
    for step in range(4):
        g = _rand_tree(10 + step)
        d_ref, r_ref = ref_comp.compress_tree(_to_jax(g), r_ref)
        d_got, r_got = comp.compress_tree(_to_torch(g), r_got)
        for a, b in zip(jax.tree.leaves(d_ref) + jax.tree.leaves(r_ref),
                        tree_flatten(d_got)[0] + tree_flatten(r_got)[0]):
            np.testing.assert_array_equal(_np(b), np.asarray(a))


def test_compress_bounded_error():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 1, size=(32, 64)).astype(np.float32))
    q, scale, resid = comp.compress(g, torch.zeros_like(g))
    deq = comp.decompress(q, scale)
    # per-row max error ≤ scale/2 + rounding
    err = (deq - g).abs()
    assert bool((err <= scale * 0.51 + 1e-7).all())
    np.testing.assert_allclose(resid.numpy(), (g - deq).numpy(),
                               rtol=1e-6, atol=1e-7)


def test_error_feedback_unbiased_over_steps():
    """With error feedback the sum of dequantized grads tracks the sum of
    the true ones: the deficit is the residual, bounded."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros((16, 32), np.float32)
    deq_sum = np.zeros_like(true_sum)
    resid = {"g": torch.zeros((16, 32))}
    for _ in range(50):
        g = rng.normal(0, 1, size=(16, 32)).astype(np.float32)
        true_sum += g
        deq, resid = comp.compress_tree({"g": torch.from_numpy(g)}, resid)
        deq_sum += deq["g"].numpy()
    assert np.abs(true_sum - deq_sum).max() < 0.1


def test_init_residuals_zeros_and_psum_over_one_rank(tmp_path):
    """Zero residuals; ``compressed_psum`` over one gloo rank against the
    reference's under ``jax.vmap`` over one slice, bit for bit."""
    from repro_torch.launch.cluster import initialize_from_env
    from repro_torch.launch.mesh import make_debug_mesh
    r = comp.init_residuals({"a": torch.ones(3), "b": torch.ones(())})
    assert all(float(x.abs().sum()) == 0 and x.dtype == torch.float32
               for x in tree_flatten(r)[0])
    rng = np.random.default_rng(3)
    g = rng.normal(size=(1, 6, 10)).astype(np.float32)
    res = (rng.normal(size=(1, 6, 10)) * 0.01).astype(np.float32)
    ref_out, ref_res = jax.vmap(
        lambda a, b: ref_comp.compressed_psum(a, b, "data"),
        axis_name="data")(g, res)
    initialize_from_env(f"file://{tmp_path}/store", 1, 0, device="cpu",
                        timeout_s=60)
    try:
        with make_debug_mesh(1, 1, device="cpu"):
            out, new_res = comp.compressed_psum(torch.from_numpy(g[0]),
                                                torch.from_numpy(res[0]),
                                                "data")
    finally:
        torch.distributed.destroy_process_group()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out[0]))
    np.testing.assert_array_equal(new_res.numpy(), np.asarray(ref_res[0]))


# ---------------------------------------------------------------- optimizer
def _adam_pair(state_dtype, **kw):
    return (ref_opt.Adam(ref_opt.AdamConfig(state_dtype=state_dtype, **kw)),
            opt.Adam(opt.AdamConfig(state_dtype=state_dtype, **kw)))


def _assert_state_close(ref_tree, got_tree):
    ref_leaves = jax.tree.leaves(ref_tree)
    got_leaves = tree_flatten(got_tree)[0]
    assert len(ref_leaves) == len(got_leaves)
    for a, b in zip(ref_leaves, got_leaves):
        a, b = np.asarray(a), _np(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max(initial=0) <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=ADAM_RTOL, atol=ADAM_ATOL)


@pytest.mark.parametrize("state_dtype", ["f32", "int8"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adam_update_matches_reference_over_3_steps(state_dtype,
                                                    weight_decay):
    ref, got = _adam_pair(state_dtype, lr=1e-2, weight_decay=weight_decay)
    p_ref = _to_jax(_rand_tree(0))
    p_got = _to_torch(_rand_tree(0))
    s_ref, s_got = ref.init(p_ref), got.init(p_got)
    _assert_state_close(s_ref, s_got)
    for step in range(3):
        g = _rand_tree(100 + step, scale=0.1)
        p_ref, s_ref = ref.update(_to_jax(g), s_ref, p_ref)
        p_got, s_got = got.update(_to_torch(g), s_got, p_got)
        _assert_state_close({"opt": s_ref, "p": p_ref},
                            {"opt": s_got, "p": p_got})
    assert int(s_got["step"]) == 3 and s_got["step"].dtype == torch.int32


@pytest.mark.parametrize("sqrt_domain", [False, True])
def test_int8_moment_codec_matches_reference(sqrt_domain):
    """``_q8``/``_q8_sqrt`` and their inverses, the 0-d branch included
    (which scales by |x|, not |x| / 127, in both packages)."""
    rng = np.random.default_rng(3)
    enc_r, dec_r = ((ref_opt._q8_sqrt, ref_opt._dq8_sqrt) if sqrt_domain
                    else (ref_opt._q8, ref_opt._dq8))
    enc_g, dec_g = ((opt._q8_sqrt, opt._dq8_sqrt) if sqrt_domain
                    else (opt._q8, opt._dq8))
    for shape in SHAPES:
        x = np.array(np.abs(rng.normal(0, 1e-3, shape)), np.float32)
        q_r, s_r = enc_r(jnp.asarray(x))
        q_g, s_g = enc_g(torch.from_numpy(x))
        np.testing.assert_array_equal(q_g.numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(s_g.numpy(), np.asarray(s_r))
        np.testing.assert_array_equal(dec_g(q_g, s_g).numpy(),
                                      np.asarray(dec_r(q_r, s_r)))
    q, s = opt._q8(torch.tensor(0.25))
    assert int(q) == 127 and float(s) == 0.25


def test_adam_quadratic_convergence():
    adam = opt.Adam(opt.AdamConfig(lr=0.1))
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adam.init(params)
    for _ in range(200):
        params, state = adam.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_adam_int8_state_tracks_f32():
    p0 = {"w": torch.linspace(-2, 2, 64).reshape(8, 8)}
    g = {"w": torch.ones((8, 8)) * 0.5}
    opt_f = opt.Adam(opt.AdamConfig(lr=0.05, state_dtype="f32"))
    opt_q = opt.Adam(opt.AdamConfig(lr=0.05, state_dtype="int8"))
    pf, sf = p0, opt_f.init(p0)
    pq, sq = p0, opt_q.init(p0)
    for _ in range(20):
        pf, sf = opt_f.update(g, sf, pf)
        pq, sq = opt_q.update(g, sq, pq)
    np.testing.assert_allclose(pf["w"].numpy(), pq["w"].numpy(), rtol=0.05,
                               atol=0.05)


def test_adam_int8_state_bytes_and_specs():
    s = opt.Adam(opt.AdamConfig(state_dtype="int8")).init(
        {"w": torch.zeros((128, 256))})
    assert s["m"]["w"]["q"].dtype == torch.int8
    assert tuple(s["m"]["w"]["scale"].shape) == (128, 1)
    specs = opt.Adam(opt.AdamConfig(state_dtype="int8")) \
        .state_logical_specs({"w": ("embed", "ff")})
    assert specs["m"]["w"]["q"] == ("embed", "ff") and specs["step"] == ()
    with pytest.raises(ValueError, match="state_dtype"):
        opt.Adam(opt.AdamConfig(state_dtype="int4"))


# --------------------------------------------------------------- checkpoint
def _tree():
    return {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.ones((2,), np.int32),
                  "d": np.zeros((), np.float32)}}


def _state_tree(seed=0):
    """A train state's shape: f32 params, int8 moments, an int32 step and
    residuals, as numpy."""
    p = _rand_tree(seed)
    mom = jax.tree.map(lambda a: {
        "q": np.full(np.shape(a), 3, np.int8),
        "scale": np.ones(np.shape(a)[:-1] + (1,) if np.ndim(a) else (),
                         np.float32)}, p)
    return {"params": p,
            "opt": {"m": mom, "v": mom, "step": np.int32(5)},
            "residuals": jax.tree.map(lambda a: np.zeros((), np.float32), p)}


def _files(d):
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d))}


def test_checkpoint_crosses_both_ways_byte_for_byte(tmp_path):
    """The same tree saved by each package gives the same files, manifest
    included (its treedef string too); each package restores the other's
    bit for bit."""
    tree = _state_tree()
    ref_dir, got_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save(ref_dir, 9, _to_jax(tree))
    ckpt.save(got_dir, 9, _to_torch(tree))
    ref_files = _files(os.path.join(ref_dir, "step_00000009"))
    got_files = _files(os.path.join(got_dir, "step_00000009"))
    assert ref_files == got_files
    assert open(os.path.join(got_dir, "LATEST")).read() == "step_00000009"
    manifest = msgpack.unpackb(got_files["manifest.msgpack"])
    assert ckpt._unpackb(got_files["manifest.msgpack"]) == manifest
    assert msgpack.packb(manifest) == got_files["manifest.msgpack"]

    got, step = ckpt.restore(ref_dir, _to_torch(tree))
    assert step == 9
    back, step = ref_ckpt.restore(got_dir, _to_jax(tree))
    assert step == 9
    for a, b, c in zip(jax.tree.leaves(tree), tree_flatten(got)[0],
                       jax.tree.leaves(back)):
        assert b.dtype == torch.from_numpy(np.asarray(a)).dtype
        np.testing.assert_array_equal(b.numpy(), a)
        np.testing.assert_array_equal(np.asarray(c), a)


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**63,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
    "", "s" * 31, "s" * 32, "s" * 255, "s" * 256, "é" * 70000,
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"leaves": [{"shape": [3, 4], "dtype": "float32", "crc": 4294967295}]},
])
def test_manifest_codec_matches_msgpack(value):
    packed = ckpt._packb(value)
    assert packed == msgpack.packb(value)
    assert ckpt._unpackb(packed) == msgpack.unpackb(packed)


def test_manifest_codec_refuses_what_it_cannot_write():
    for bad in (1.5, None, True, b"x", {1: 2}):
        with pytest.raises(TypeError):
            ckpt._packb(bad)
    with pytest.raises(ValueError, match="trailing"):
        ckpt._unpackb(msgpack.packb(1) + b"\x01")
    with pytest.raises(ValueError, match="not in the manifest codec"):
        ckpt._unpackb(msgpack.packb(1.5))


def test_ckpt_roundtrip(tmp_path):
    t = _to_torch(_tree())
    ckpt.save(str(tmp_path), 7, t)
    got, step = ckpt.restore(str(tmp_path), t)
    assert step == 7
    for a, b in zip(tree_flatten(t)[0], tree_flatten(got)[0]):
        assert torch.equal(a, b)


def test_ckpt_latest_and_cleanup(tmp_path):
    t = _to_torch(_tree())
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 5
    ckpt.cleanup(str(tmp_path), keep=2)
    dirs = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    assert ckpt.restore(str(tmp_path), t)[1] == 5
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), t)


def test_ckpt_crc_detects_corruption(tmp_path):
    t = _to_torch(_tree())
    ckpt.save(str(tmp_path), 1, t)
    victim = os.path.join(tmp_path, "step_00000001", "arr_0.npy")
    data = bytearray(open(victim, "rb").read())
    data[-1] ^= 0xFF
    open(victim, "wb").write(bytes(data))
    with pytest.raises(IOError, match="CRC"):
        ckpt.restore(str(tmp_path), t)


def test_ckpt_shape_mismatch_rejected(tmp_path):
    """The reference asserts; the port raises ValueError (a check that
    ``python -O`` keeps)."""
    ckpt.save(str(tmp_path), 1, _to_torch(_tree()))
    bad = _to_torch(_tree())
    bad["a"] = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="leaf 0"):
        ckpt.restore(str(tmp_path), bad)
    bad = _to_torch(_tree())
    del bad["b"]["d"]
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), bad)


def test_ckpt_atomic_tmp_never_latest(tmp_path):
    """A stale .tmp dir is never a checkpoint, and a new save over one
    replaces it."""
    t = _to_torch(_tree())
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(os.path.join(tmp_path, "step_00000099.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    os.makedirs(os.path.join(tmp_path, "step_00000002.tmp"))
    ckpt.save(str(tmp_path), 2, t)
    assert ckpt.latest_step(str(tmp_path)) == 2
    assert not os.path.exists(os.path.join(tmp_path, "step_00000002.tmp"))
    assert not os.path.exists(os.path.join(tmp_path, "LATEST.tmp"))


# ----------------------------------------------------------- fault tolerance
def test_straggler_detector():
    det = StragglerDetector(window=8, multiplier=3.0, grace=2)
    assert not det.observe(60.0)       # grace (the first step's warm-up)
    assert not det.observe(1.0)
    for _ in range(6):
        assert not det.observe(1.0)
    assert det.observe(5.0)            # 5 > 3×1.0
    assert not det.observe(1.1)
    assert det.median == pytest.approx(1.0, rel=0.2)
    assert det.deadline() == pytest.approx(3.0, rel=0.2)
    # a straggler must not poison the window
    assert det.observe(5.0)


def test_heartbeat_survey(tmp_path):
    hb0 = Heartbeat(str(tmp_path), 0)
    hb1 = Heartbeat(str(tmp_path), 1)
    hb0.beat(10, now=1000.0)
    hb1.beat(10, now=900.0)            # stale
    (tmp_path / "host_00002.hb").write_text("{not json")
    got = Heartbeat.survey(str(tmp_path), timeout_s=30.0, now=1001.0)
    assert got[0]["alive"] and not got[1]["alive"]
    assert got[0]["step"] == 10
    assert got[2] == {"step": -1, "time": 0.0, "alive": False}


@pytest.mark.parametrize("alive, dp, accum, dropped", [
    ([0, 1, 2, 3, 4, 6], 4, 2, (5, 7)),
    (list(range(8)), 8, 1, ()),
])
def test_elastic_plan(alive, dp, accum, dropped):
    plan = plan_elastic_restart(alive=alive, total_hosts=8, dp_size=8,
                                global_batch=256)
    assert plan.dp_size == dp and plan.accum_steps == accum
    assert plan.global_batch == 256
    assert set(dropped) <= set(plan.dropped_hosts)
    if not dropped:
        assert plan.dropped_hosts == ()


def test_preemption_flag():
    f = PreemptionFlag()
    assert not f
    f.set()
    assert f
