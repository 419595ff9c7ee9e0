"""The port's ``Trainer`` and ``run_loop`` (``launch/train.py``) on the CPU.

1. Three ``Trainer.train_step`` calls, from a checkpoint the reference
   wrote, against the reference's step assembled from its pieces:
   ``jax.value_and_grad(Model.loss_fn)`` (micro-batches summed in f32 for
   ``accum_steps=2``), ``compress_tree``, the f32 grad norm and
   ``Adam.update``.  The reference's own ``Trainer`` cannot run here (its
   mesh policy raises ``ShardingTypeError``; ROADMAP Queue C), so its step
   is assembled as its ``_build_step`` assembles it.  f32 compute on both
   sides, f32 and int8 moments, compression on and off, the encdec
   frames.
2. The reference's training tests that are red here
   (``tests/test_train_serve.py:31-99``, ``tests/test_watchdog_integration.py``
   and ``tests/test_elastic.py``), run on the port alone, in bf16 compute
   as the reference's trainer runs.

Tolerances of (1): losses and grad norms rtol 1e-5; state leaves rtol /
atol 1e-5 (measured ~3e-6: the same f32 arithmetic in another order); an
int8 moment at most one step apart.  With compression a gradient entry
whose quotient sits at a rounding tie may round one step the other way in
one package, which moves that entry's Adam update by up to 2·lr a step:
there at most 0.1% of each leaf may lie beyond 1e-5, and no param further
than 2·lr·steps.
"""
import signal

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.data.tokens import SyntheticTokens as RefTokens  # noqa: E402
from repro.data.tokens import TokenPipelineConfig as RefTokensCfg  # noqa: E402
from repro.distributed import checkpoint as ref_ckpt  # noqa: E402
from repro.distributed import compression as ref_comp  # noqa: E402
from repro.distributed import optimizer as ref_opt  # noqa: E402
from repro.launch.specs import enc_len as ref_enc_len  # noqa: E402
from repro.models.model import Model as RefModel  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.fault_tolerance import (  # noqa: E402
    Heartbeat, plan_elastic_restart)
from repro_torch.kernels.flash_attention_kernel import (  # noqa: E402
    flash_forward)
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.specs import enc_len  # noqa: E402
from repro_torch.launch.train import Trainer, run_loop  # noqa: E402
from repro_torch.models.model import tree_flatten  # noqa: E402

B, S, LR, STEPS = 2, 32, 3e-4, 3
STATE_TOL = 1e-5
FLIP_SHARE = 1e-3


@pytest.fixture(scope="module")
def vg_cache():
    """Jitted reference value_and_grad per (config, batch)."""
    return {}


def _ref_vg(cache, name, batch):
    if (name, batch) not in cache:
        cfg = ref_configs.get_config(name).reduced()
        model = RefModel(cfg, compute_dtype=jnp.float32, q_chunk=min(512, S),
                         ssd_chunk=min(128, S), loss_chunk=min(512, S),
                         remat=False)
        cache[name, batch] = (cfg, model,
                              jax.jit(jax.value_and_grad(model.loss_fn)))
    return cache[name, batch]


def _ref_inputs(cfg, step):
    """The reference trainer's batch of ``step``: its tokens and, for
    encdec, its frames (``launch/train.py:191-197``)."""
    tokens = RefTokens(RefTokensCfg(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B, seed=0)).batch(step)
    if cfg.family != "encdec":
        return jnp.asarray(tokens), None
    rng = np.random.default_rng((17, step))
    enc = rng.normal(0, 1, size=(B, ref_enc_len(cfg, S), cfg.d_model))
    return jnp.asarray(tokens), jnp.asarray(enc.astype(np.float32))


def _ref_step(cache, name, state, step, *, opt, compress, accum):
    """One reference step, assembled as ``Trainer._build_step`` does."""
    params, opt_state, residuals = state
    cfg, _, _ = _ref_vg(cache, name, B)
    tokens, enc = _ref_inputs(cfg, step)
    b = B // accum
    vg = _ref_vg(cache, name, b)[2]
    loss = jnp.zeros((), jnp.float32)
    grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
    for i in range(accum):
        rows = slice(i * b, (i + 1) * b)
        args = (tokens[rows],) + (() if enc is None else (enc[rows],))
        l, g = vg(params, *args)
        loss = loss + l
        grads = jax.tree.map(lambda a, c: a + c.astype(jnp.float32), grads,
                             g)
    if accum > 1:
        inv = 1.0 / accum
        loss, grads = loss * inv, jax.tree.map(lambda g: g * inv, grads)
    if compress:
        grads, residuals = ref_comp.compress_tree(grads, residuals)
    gnorm = jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(jnp.float32)))
                         for g in jax.tree.leaves(grads)))
    params, opt_state = opt.update(grads, opt_state, params)
    return (params, opt_state, residuals), float(loss), float(gnorm)


def _assert_state(ref_tree, got_tree, compress):
    ref_leaves = jax.tree.leaves(ref_tree)
    got_leaves = tree_flatten(got_tree)[0]
    assert len(ref_leaves) == len(got_leaves)
    for i, (a, b) in enumerate(zip(ref_leaves, got_leaves)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if a.dtype == np.int8:
            assert np.abs(a.astype(int) - b.astype(int)).max(initial=0) <= 1
            continue
        off = np.abs(b - a) > STATE_TOL * (1 + np.abs(a))
        if compress:
            assert off.mean() <= FLIP_SHARE, (i, int(off.sum()), a.size)
        else:
            assert not off.any(), (i, float(np.abs(b - a).max()))


@pytest.mark.parametrize("name, opt_state, compress, accum", [
    ("smollm_360m", "f32", False, 1),
    ("smollm_360m", "int8", False, 1),
    ("smollm_360m", "f32", True, 1),
    ("smollm_360m", "int8", True, 1),
    ("smollm_360m", "f32", False, 2),
    ("seamless_m4t_large_v2", "f32", False, 1),
])
def test_train_steps_match_the_reference_step(vg_cache, tmp_path, name,
                                              opt_state, compress, accum):
    cfg, model, _ = _ref_vg(vg_cache, name, B)
    params = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    opt = ref_opt.Adam(ref_opt.AdamConfig(lr=LR, state_dtype=opt_state))
    residuals = (ref_comp.init_residuals(params) if compress else
                 jax.tree.map(lambda _: jnp.zeros(()), params))
    state = (params, opt.init(params), residuals)
    ref_ckpt.save(str(tmp_path), 0, dict(zip(("params", "opt", "residuals"),
                                             state)))

    tr = Trainer(configs.get_config(name).reduced(), batch=B, seq_len=S,
                 lr=LR, opt_state=opt_state, compress_grads=compress,
                 accum_steps=accum, compute_dtype=torch.float32,
                 device="cpu")
    assert tr.restore(str(tmp_path)) == 0
    for step in range(STEPS):
        state, loss, gnorm = _ref_step(vg_cache, name, state, step, opt=opt,
                                       compress=compress, accum=accum)
        rec = tr.train_step()
        assert rec["step"] == step + 1
        assert rec["loss"] == pytest.approx(loss, rel=1e-5)
        assert rec["grad_norm"] == pytest.approx(gnorm, rel=1e-5)
    _assert_state(dict(zip(("params", "opt", "residuals"), state)),
                  tr.state_tree(), compress)
    if compress:
        np.testing.assert_allclose(
            *(np.concatenate([np.ravel(np.asarray(x)) for x in leaves])
              for leaves in (tree_flatten(tr.params)[0],
                             jax.tree.leaves(state[0]))),
            rtol=0, atol=2 * LR * STEPS)


def test_port_checkpoint_restores_in_the_reference(vg_cache, tmp_path):
    """A trainer's state saved by the port after two steps loads in the
    reference's ``restore`` (its target tree the reference's own init) bit
    for bit."""
    cfg, model, _ = _ref_vg(vg_cache, "smollm_360m", B)
    tr = Trainer(configs.get_config("smollm_360m").reduced(), batch=B,
                 seq_len=S, opt_state="int8", device="cpu")
    tr.init_state()
    for _ in range(2):
        tr.train_step()
    tr.save(str(tmp_path))
    params = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    opt = ref_opt.Adam(ref_opt.AdamConfig(state_dtype="int8"))
    target = {"params": params, "opt": opt.init(params),
              "residuals": jax.tree.map(lambda _: jnp.zeros(()), params)}
    got, step = ref_ckpt.restore(str(tmp_path), target)
    assert step == 2
    for a, b in zip(jax.tree.leaves(got), tree_flatten(tr.state_tree())[0]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ------------------------------------------------- the reference's tests
@pytest.fixture(scope="module")
def tiny_cfg():
    return configs.get_config("smollm_360m").reduced()


@pytest.fixture(scope="module")
def trainer_f(tiny_cfg):
    def make(**kw):
        return Trainer(tiny_cfg, batch=2, seq_len=32, device="cpu", **kw)
    return make


def test_loss_decreases(trainer_f):
    tr = trainer_f(lr=1e-2)
    tr.init_state()
    before = flash_forward.launches
    losses = [tr.train_step()["loss"] for _ in range(8)]
    assert losses[-1] < losses[0]
    assert all(np.isfinite(l) for l in losses)
    assert flash_forward.launches == before        # backend="torch"


def test_checkpoint_restart_bit_identical(trainer_f, tmp_path):
    """train 4 steps ≡ train 2, checkpoint, restore in a NEW trainer,
    train 2: losses, params and moments bit for bit."""
    tr1 = trainer_f()
    tr1.init_state()
    for _ in range(2):
        tr1.train_step()
    tr1.save(str(tmp_path))
    r = [tr1.train_step() for _ in range(2)]

    tr2 = trainer_f()
    assert tr2.restore(str(tmp_path)) == 2
    s = [tr2.train_step() for _ in range(2)]
    assert [x["loss"] for x in s] == [x["loss"] for x in r]
    assert [x["grad_norm"] for x in s] == [x["grad_norm"] for x in r]
    for a, b in zip(tree_flatten(tr1.state_tree())[0],
                    tree_flatten(tr2.state_tree())[0]):
        assert torch.equal(a, b)


def test_compressed_grads_still_learn(trainer_f):
    tr = trainer_f(lr=1e-2, compress_grads=True)
    tr.init_state()
    losses = [tr.train_step()["loss"] for _ in range(8)]
    assert losses[-1] < losses[0]


def test_int8_opt_state_still_learns(trainer_f):
    tr = trainer_f(lr=1e-2, opt_state="int8")
    tr.init_state()
    losses = [tr.train_step()["loss"] for _ in range(12)]
    # int8 moments are noisy step to step: trailing vs leading averages
    assert np.mean(losses[-3:]) < np.mean(losses[:3])


def test_run_loop_writes_ckpt_and_log(trainer_f, tmp_path):
    tr = trainer_f()
    log = tmp_path / "log.jsonl"
    handler = signal.getsignal(signal.SIGTERM)
    recs = run_loop(tr, steps=4, ckpt_dir=str(tmp_path / "ck"),
                    ckpt_every=2, log_path=str(log),
                    hb_dir=str(tmp_path / "hb"))
    assert len(recs) == 4
    assert ckpt.latest_step(str(tmp_path / "ck")) == 4
    assert len(log.read_text().strip().splitlines()) == 4
    hb = Heartbeat.survey(str(tmp_path / "hb"), timeout_s=1e9)
    assert hb[0]["step"] == 4
    assert signal.getsignal(signal.SIGTERM) == handler


def test_run_loop_resume(trainer_f, tmp_path):
    tr = trainer_f()
    run_loop(tr, steps=3, ckpt_dir=str(tmp_path / "ck"), ckpt_every=1)
    tr2 = trainer_f()
    recs = run_loop(tr2, steps=5, ckpt_dir=str(tmp_path / "ck"),
                    ckpt_every=1)
    assert [r["step"] for r in recs] == [4, 5]


def test_straggler_flagged_in_records(trainer_f, monkeypatch):
    """The reference's case on a clock the test advances: every step takes
    1 s, the eighth 5 s.  (The reference sleeps 2 s inside its eighth step
    on the real clock; a CPU step of ~40 ms is then too short for the
    3× rule: the step after the sleep, with the thread pool woken again,
    ran 3.3× the median.)"""
    tr = trainer_f()
    tr.init_state()
    real_step = tr.train_step
    count = {"n": 0}
    clock = {"t": 0.0}

    def slow_sometimes():
        count["n"] += 1
        rec = real_step()
        clock["t"] += 5.0 if count["n"] == 8 else 1.0
        return rec

    monkeypatch.setattr(train.time, "time", lambda: clock["t"])
    monkeypatch.setattr(tr, "train_step", slow_sometimes)
    records = run_loop(tr, steps=10, ckpt_dir=None, log_every=100)
    assert [r["step"] for r in records if r.get("straggler")] == [8]


def test_preemption_checkpoints_and_exits(trainer_f, tmp_path, monkeypatch):
    tr = trainer_f()
    tr.init_state()
    real_step = tr.train_step
    count = {"n": 0}

    def step_then_sigterm():
        count["n"] += 1
        rec = real_step()
        if count["n"] == 3:
            signal.raise_signal(signal.SIGTERM)   # delivered synchronously
        return rec

    monkeypatch.setattr(tr, "train_step", step_then_sigterm)
    records = run_loop(tr, steps=100, ckpt_dir=str(tmp_path),
                       ckpt_every=1000, log_every=100)
    assert len(records) == 3                      # stopped early
    assert ckpt.latest_step(str(tmp_path)) == 3   # checkpointed on the flag


@pytest.mark.parametrize("dtype, step0_rtol", [(torch.float32, 1e-5),
                                               (torch.bfloat16, 1e-4)])
def test_accum_matches_full_batch(tiny_cfg, dtype, step0_rtol):
    """One step with accum=2 ≡ one step with accum=1 (the same global
    batch).  Later steps to the reference's 1e-3 (``tests/test_elastic.py
    :20``: Adam amplifies the step-0 difference).  Step 0 in f32 to the
    reference's 1e-5 (summation order alone).  In bf16, the compute dtype
    of the reference's trainer, each micro-batch's weight gradients are
    bf16 products rounded to bf16 before the f32 sum; the reference's own
    scanned step (``launch/train.py:107-135``) on this model and batch
    gives grad norms 3.7e-5 apart, above its test's 1e-5, so step 0 is held
    to 1e-4 there."""
    t1 = Trainer(tiny_cfg, batch=4, seq_len=32, accum_steps=1,
                 compute_dtype=dtype, device="cpu")
    t2 = Trainer(tiny_cfg, batch=4, seq_len=32, accum_steps=2,
                 compute_dtype=dtype, device="cpu")
    t1.init_state()
    t2.init_state()
    r1 = [t1.train_step() for _ in range(3)]
    r2 = [t2.train_step() for _ in range(3)]
    assert r1[0]["loss"] == pytest.approx(r2[0]["loss"], rel=step0_rtol)
    assert r1[0]["grad_norm"] == pytest.approx(r2[0]["grad_norm"],
                                               rel=step0_rtol)
    for a, b in zip(r1[1:], r2[1:]):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-3)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-3)


def test_elastic_shrink_restart_continues_trajectory(tiny_cfg, tmp_path):
    """A simulated host loss: checkpoint, replan on half the hosts (accum
    ×2), restore, continue — the losses of the uninterrupted run."""
    big = Trainer(tiny_cfg, batch=4, seq_len=32, accum_steps=1, device="cpu")
    big.init_state()
    for _ in range(2):
        big.train_step()
    big.save(str(tmp_path))
    ref = [big.train_step()["loss"] for _ in range(2)]
    plan = plan_elastic_restart(alive=[0], total_hosts=2, dp_size=2,
                                global_batch=4)
    assert plan.dp_size == 1 and plan.accum_steps == 2
    small = Trainer(tiny_cfg, batch=plan.global_batch, seq_len=32,
                    accum_steps=plan.accum_steps, device="cpu")
    assert small.restore(str(tmp_path)) == 2
    got = [small.train_step()["loss"] for _ in range(2)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)


# ---------------------------------------------------------- the launcher
def test_reproducible_sets_and_restores_the_process_mode():
    """On a CUDA device ``reproducible`` turns on deterministic kernels
    (strict) with the NaN fill of fresh memory off, and restores both on
    exit, also when the body raises; on the CPU it changes nothing.  (The
    flags are process state; no card is needed to set them.)"""
    det = torch.utils.deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              det.fill_uninitialized_memory)
    with train.reproducible(torch.device("cuda")):
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert not det.fill_uninitialized_memory
    assert (torch.are_deterministic_algorithms_enabled(),
            det.fill_uninitialized_memory) == before
    with pytest.raises(KeyError):
        with train.reproducible(torch.device("cuda")):
            raise KeyError("body")
    assert (torch.are_deterministic_algorithms_enabled(),
            det.fill_uninitialized_memory) == before
    with train.reproducible(torch.device("cpu")):
        assert (torch.are_deterministic_algorithms_enabled(),
                det.fill_uninitialized_memory) == before


def test_encdec_frames_and_enc_len_match_the_reference(tiny_cfg):
    cfg = configs.get_config("seamless_m4t_large_v2").reduced()
    ref_cfg = ref_configs.get_config("seamless_m4t_large_v2").reduced()
    for s in (8, 32, 4096, 10 ** 6):
        assert enc_len(cfg, s) == ref_enc_len(ref_cfg, s)
    tr = Trainer(cfg, batch=B, seq_len=S, device="cpu")
    tokens, enc = tr.batch_inputs(3)
    ref_tokens, ref_enc = _ref_inputs(ref_cfg, 3)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(ref_enc))
    tokens, enc = Trainer(tiny_cfg, batch=B, seq_len=S,
                          device="cpu").batch_inputs(0)
    assert enc is None and tuple(tokens.shape) == (B, S)


def test_trainer_refuses_what_waits_for_12_6(tiny_cfg):
    """What the trainer refuses now that meshes train (the name is from
    before, when every mesh raised): a mesh that is not a ``Mesh``, an
    abstract mesh (with a "model" axis above 1 or not), the production
    mesh on one process, and a batch that ``accum_steps`` does not
    divide."""
    from repro_torch.launch.mesh import Mesh
    with pytest.raises(TypeError, match="Mesh"):
        Trainer(tiny_cfg, batch=2, seq_len=32, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="live mesh"):
        Trainer(tiny_cfg, batch=2, seq_len=32, device="cpu",
                mesh=Mesh.abstract((1, 2), ("data", "model")))
    with pytest.raises(ValueError, match="live mesh"):
        Trainer(tiny_cfg, batch=2, seq_len=32, device="cpu",
                mesh=Mesh.abstract((1, 1), ("data", "model")))
    with pytest.raises(ValueError, match="needs 256 processes"):
        train.main(["--reduced", "--mesh", "production", "--device", "cpu"])
    with pytest.raises(ValueError, match="accum_steps"):
        Trainer(tiny_cfg, batch=3, seq_len=32, accum_steps=2, device="cpu")


def test_main_trains_checkpoints_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train`` in process: two steps with a
    checkpoint, then a resumed run to four."""
    argv = ["--arch", "smollm_360m", "--reduced", "--batch", "2",
            "--seq-len", "32", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-every", "2", "--log", str(tmp_path / "log.jsonl"),
            "--device", "cpu"]
    recs = train.main(argv + ["--steps", "2"])
    assert [r["step"] for r in recs] == [1, 2]
    recs = train.main(argv + ["--steps", "4", "--opt-state", "f32"])
    assert [r["step"] for r in recs] == [3, 4]
    assert ckpt.latest_step(str(tmp_path / "ck")) == 4
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 4
    assert all(np.isfinite(r["loss"]) for r in recs)


@pytest.mark.parametrize("opt_state, compress", [("f32", False),
                                                 ("int8", True)])
def test_train_state_from_reference_equals_the_restored_checkpoint(
        vg_cache, tmp_path, opt_state, compress):
    """``models/convert.py`` carries a reference train state (numpy) to the
    port's, the same tree, bit for bit, that restoring the reference's
    checkpoint of it gives; a trainer takes it and steps."""
    from repro_torch.models.convert import train_state_from_reference
    cfg, model, _ = _ref_vg(vg_cache, "smollm_360m", B)
    params = model.init_params(jax.random.PRNGKey(0), jnp.float32)
    opt = ref_opt.Adam(ref_opt.AdamConfig(state_dtype=opt_state))
    state = {"params": params, "opt": opt.init(params),
             "residuals": (ref_comp.init_residuals(params) if compress else
                           jax.tree.map(lambda _: jnp.zeros(()), params))}
    ref_ckpt.save(str(tmp_path), 0, state)
    tr = Trainer(configs.get_config("smollm_360m").reduced(), batch=B,
                 seq_len=S, opt_state=opt_state, compress_grads=compress,
                 device="cpu")
    tr.restore(str(tmp_path))
    got = train_state_from_reference(jax.tree.map(np.asarray, state),
                                     configs.get_config("smollm_360m")
                                     .reduced())
    for a, b in zip(tree_flatten(got)[0], tree_flatten(tr.state_tree())[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tr.params, tr.opt_state, tr.residuals = (got["params"], got["opt"],
                                             got["residuals"])
    assert np.isfinite(tr.train_step()["loss"])


def test_train_state_from_reference_refuses_a_wrong_tree(vg_cache):
    from repro_torch.models.convert import train_state_from_reference
    cfg, model, _ = _ref_vg(vg_cache, "smollm_360m", B)
    params = jax.tree.map(np.asarray,
                          model.init_params(jax.random.PRNGKey(0)))
    zeros = jax.tree.map(np.zeros_like, params)
    good = {"params": params,
            "opt": {"m": zeros, "v": zeros, "step": np.int32(0)},
            "residuals": jax.tree.map(lambda _: np.float32(0), params)}
    port_cfg = configs.get_config("smollm_360m").reduced()
    train_state_from_reference(good, port_cfg)
    bad_step = dict(good, opt=dict(good["opt"], step=np.int64(0)))
    int8 = jax.tree.map(lambda a: {"q": np.zeros(a.shape, np.int8),
                                   "scale": np.zeros(a.shape[:-1] + (1,),
                                                     np.float32)}, params)
    mixed_m = dict(int8, embed=zeros["embed"])
    for bad, err in ((dict(good, opt={"m": zeros}), ValueError),
                     (bad_step, ValueError),
                     (dict(good, opt=dict(good["opt"], m=mixed_m)),
                      ValueError),
                     (dict(good, residuals=dict(
                         good["residuals"], embed=zeros["embed"])),
                      ValueError),
                     (dict(good, opt=dict(good["opt"], v=jax.tree.map(
                         lambda a: a.astype(np.float64), zeros))),
                      ValueError)):
        with pytest.raises(err):
            train_state_from_reference(bad, port_cfg)
