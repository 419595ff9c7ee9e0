"""Import hygiene: the port and ``chip_smoke.py`` import neither JAX nor
the reference package, run on an explicit CPU device, and refuse to run
without a card when no device is named."""
import pytest

pytest.importorskip("torch")

import ast  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"

# Runs in a fresh interpreter where importing jax or repro fails outright.
HYGIENE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
# the shapes here are tiny: spare intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
assert "repro_torch.distributed.collectives" in names
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, mod in sys.modules.items() if mod is not None)

from repro_torch import core
forest = core.random_forest_ir(8, 16, 6, n_classes=2, seed=0)
X = np.random.default_rng(0).normal(size=(40, 6))
pred, _, server, _ = chip_smoke.main_path(forest, X, X, torch.device("cpu"))
assert server.stats.n_requests == 40
want = core.quantize_forest(forest, X, chip_smoke.QUANT)
np.testing.assert_array_equal(
    pred.predict(X),
    core.compile_forest(want, backend="torch", device="cpu").predict(X))
from repro_torch.data import datasets
from repro_torch.trees.random_forest import RandomForest, RandomForestConfig
ds = datasets.make_mnist(n=600)
rf = RandomForest(RandomForestConfig(n_trees=16, max_leaves=8, seed=0))
res = chip_smoke.cascade_path(
    core.from_random_forest(rf.fit(ds.X_train, ds.y_train)), ds.X_train,
    ds.X_test[:60], ds.y_test[:60], ds.X_test[60:], ds.y_test[60:],
    torch.device("cpu"), stages=(4, 8, 16))
assert res["launches"] == 0 and sum(res["exit_fractions"]) > 0.999
split = chip_smoke.host_split(res["fused"], ds.X_test[60:100], reps=2)
assert split["bucket"] == 128 and min(split.values()) >= 0
assert set(split) == {"transform", "pad", "h2d", "launch", "d2h", "bucket"}
# phase 3's input-transform check on a small forest (the plain version)
msn = datasets.make_msn()
small = core.random_forest_ir(8, 16, 136, seed=0)
qc = chip_smoke.quantize_check(
    msn, small, core.quantize_forest(small, msn.X_train, chip_smoke.QUANT),
    torch.device("cpu"))
assert qc["launches"] == 0 and qc["magic_rows"].shape == (65536, 10)
err, counts = chip_smoke.compare_cascade(
    res["qforest"], (4, 8, 16), res["policy"], ds.X_test[:40],
    torch.device("cpu"), 0.0, n_invalid=2)
assert err == 0 and counts.sum() == 38
# two tiles: rows 0-31 exit at 0 but row 3 (stage 2), rows 32-33 at 1
share = chip_smoke.exited_pair_share(
    torch.ones(34, dtype=torch.bool),
    torch.tensor([0, 0, 0, 2] + [0] * 28 + [1, 1]), (0, 8, 16, 32))
walked = 2 * 32 * 8 + 2 * 32 * 8 + 32 * 16
assert share == 1 - (34 * 8 + 3 * 8 + 16) / walked
import tempfile
keep = tempfile.TemporaryDirectory()
with tempfile.TemporaryDirectory() as tmp:
    out = chip_smoke.packed_path(want, X, X, torch.device("cpu"), tmp)
    assert [r["launches"] for r in out.values()] == [0, 0, 0]
    ms, p = chip_smoke.pass_times(f"{tmp}/msn.repro.npz", torch.device("cpu"),
                                  X, engine="gemm", backend="cuda", opt="O1")
    assert list(ms) == list(chip_smoke.pipeline.PIPELINE)
    np.testing.assert_array_equal(p.predict(X), pred.predict(X))
    assert "verify" in chip_smoke.opt_pass_times(want, X)
    mf = chip_smoke.model_file_cascade(
        rf, ds.X_train.shape[1], ds.X_train, ds.X_test[:60], ds.y_test[:60],
        ds.X_test[60:], ds.y_test[60:], torch.device("cpu"), tmp,
        stages=(4, 8, 16))
    assert mf["launches"] == 0
    assert mf["fused"].forest.n_features < mf["imported"].n_features
    assert len(chip_smoke.fixture_path(torch.device("cpu"))) == 18
    saved = chip_smoke.save_load_path(want, X, torch.device("cpu"), tmp)
    assert "save the forest" in saved["cuda_error"]
    cpu, cache = torch.device("cpu"), f"{keep.name}/engine_cache.json"
    sw = chip_smoke.autotune_sweep(want, X, cpu, cache, batch=64)
    assert len(sw["choice"].timings) == 18
    assert not any(sw["launches"].values())
    child = chip_smoke.autotune_second_process(want, cpu, cache, tmp, batch=64)
    assert child == {"from_cache": True, "engine": sw["choice"].engine,
                     "sweeps": 0.0}, child
    rows = np.concatenate([X] * 4)
    srv = chip_smoke.autotune_server(want, rows, pred.predict(rows), cpu,
                                     cache, batch=64)
    assert srv["n_batches"] == 3
    ct = chip_smoke.autotune_cascade(
        res["qforest"], res["stages"], res["policy"], ds.X_test[60:],
        res["served"], res["full"], cpu, cache, batch=64)
    assert len(ct["choice"].timings) == 6
    assert all(abs(sum(v) - 1) < 1e-9 for v in ct["exits"].values())
    pr = chip_smoke.autotune_predict(
        cpu, cache, f"{tmp}/cost_model.json",
        ladder=[(8, 16, 6, 1), (16, 16, 8, 3), (12, 32, 10, 1)],
        held_out=[(10, 16, 7, 1), (6, 16, 5, 3)], batch=32)
    assert pr["asked"][-1][2].predicted and pr["asked"][-1][3] >= 0
# phase 9 at a tiny size: the fleet (kernel plain versions on the CPU),
# from_forests from a cache, the fleet round trip, the launcher
preds = {e: core.compile_forest(want, engine=e, backend="cuda", device=cpu)
         for e in ("bitvector", "bitmm", "gemm")}
msn_served = preds["bitvector"].predict(X)
cfused = res["fused"]
cfused.reset_exit_stats()
crows = ds.X_test[60:140]
cserved = cfused.predict(crows)
fl = chip_smoke.runtime_fleet(preds, cfused, X, msn_served, crows,
                              cfused.last_exit_counts.tolist(), cpu,
                              max_batch=64, rate_hz=20000.0)
assert fl["n_requests"] == len(X) + len(crows) and not any(fl["launches"].values())
assert fl["summary"]["msn-qs"]["controller"]["target_p99_ms"] == fl["target"]
with tempfile.TemporaryDirectory() as tmp:
    ff = chip_smoke.runtime_from_forests(want, X, msn_served, cpu, cache,
                                         max_batch=64)
    assert ff["sweeps"] == 0 and ff["engine"] == sw["choice"].engine
    trip = chip_smoke.runtime_round_trip(
        want, res["qforest"], res["stages"], res["policy"], X, crows,
        msn_served, cserved, cpu, tmp)
    assert len(trip["tenants"]) == 3 and "save the forest" in \
        trip["cuda_error"]
launched = chip_smoke.launcher_modes(cpu, n_trees=4)
assert set(launched) == {"forest", "runtime", "lm"}
from repro_torch.configs import get_config
cfg = get_config(chip_smoke.LM_ARCH).reduced()
lm = chip_smoke.lm_path(cfg, chip_smoke.lm_prompts(cfg, 2, 20), 3,
                        torch.device("cpu"))
assert lm["launches"] == 0 and lm["tokens"].shape == (2, 23)
# phases 10 and 11 at a tiny size: sharded CPU replicas, the LM families
sh = chip_smoke.sharded_path(want, forest, X, pred.predict(X), cpu,
                             counts=(1, 3), reps=1)
assert not any(sh["launches"].values()) and set(sh["errors"]) == {"cuda"}
assert len(sh["engines"]) == 6 and sh["float_err"] < 1e-3
tiny = dict(batch=2, prompt=20, new=3, layers=None, reduced=True)
for fname in chip_smoke.LM_FAMILIES:
    fcfg, fam = chip_smoke.lm_family_path(fname, tiny, cpu)
    assert fam["launches"] == 0 and fam["tokens"].shape == (2, 23)
    assert (fam["n_attn"] == 0) == (fcfg.family == "ssm"), fcfg.name
    assert (fam["flips"][torch.float32][1] > 0) == (fcfg.n_experts > 0)
# phase 13 at a tiny size: the encdec path, the int8 KV cache
ecfg = get_config(chip_smoke.ENCDEC_ARCH).reduced()
ed = chip_smoke.encdec_path(ecfg, chip_smoke.lm_prompts(ecfg, 2, 12),
                            torch.randn(2, 24, ecfg.d_model), 3, cpu)
assert ed["launches"] == {"init": 0, "prefill": 0, "decode": 0}
assert ed["tokens"].shape == (2, 15) and ed["err32"] < 1e-4
kq = chip_smoke.kv_quant_path(cfg, chip_smoke.lm_prompts(cfg, 2, 20), 3, cpu,
                              max_ratio=0.65)
assert kq["launches"] == 0 and kq["ratio"] == 0.625
assert chip_smoke.enc_len(get_config(chip_smoke.ENCDEC_ARCH),
                          chip_smoke.ENCDEC_SEQ) == 1024
phi = chip_smoke.family_config("phi3_5_moe_42b",
                               chip_smoke.LM_FAMILIES["phi3_5_moe_42b"])
assert (phi.n_layers, phi.d_model, phi.n_experts) == (4, 4096, 16)
for shape in chip_smoke.FLASH_SWEEP[:2]:
    for dt in (torch.float32, torch.bfloat16):
        assert chip_smoke.compare_flash(*shape, dt, torch.device("cpu")) == 0
assert 120 * chip_smoke.visible_pairs(1024, 1024, True) == 62_976_000
assert chip_smoke.compare_flash(2, 16, 40, 4, 4, 16, False, torch.bfloat16,
                                cpu, steps=chip_smoke.FLASH_BF16_STEPS) == 0
assert (chip_smoke.bf16_step(0.3457), chip_smoke.bf16_step(1.0),
        chip_smoke.bf16_step(3.2)) == (2.0 ** -9, 2.0 ** -7, 2.0 ** -6)
if not torch.cuda.is_available():
    try:
        core.compile_forest(forest)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("compile_forest ran without a CUDA device")
    from repro_torch.core import engine_select
    try:
        engine_select.choose(forest, 64, engines=("qs",), cache_path=None)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("choose ran without a CUDA device")
# phase 14 at a tiny size, on the CPU: the reduced config in place of the
# full width, the card's clock and memory calls stubbed
if not torch.cuda.is_available():
    chip_smoke.get_config = lambda name: get_config(name).reduced()
    chip_smoke.TRAIN_BATCH, chip_smoke.TRAIN_SEQ = 2, 64
    chip_smoke.RESTART_BATCH, chip_smoke.RESTART_SEQ = 2, 32
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    chip_smoke.reset_launches()
    train_ref = {}
    tp = chip_smoke.train_path(cpu, "cpu", train_ref)
    assert not any(chip_smoke.launch_counts().values())
    assert 0.25 < tp["int8_state_bytes"] / tp["f32_state_bytes"] < 0.3
    # phase 15 on a one-rank gloo group: the mesh runs bit for bit phase
    # 14's, compressed_psum its plain version, the group torn down
    chip_smoke.PSUM_SHAPE = (64, 96)
    dp = chip_smoke.dp_path(cpu, "cpu", train_ref)
    assert dp["backend"] == "gloo" and dp["replicas"] == 1
    assert dp["grad_bytes"] < dp["all_reduce_bytes"]
    assert not any(chip_smoke.launch_counts().values())
    assert not torch.distributed.is_initialized()
    # phase 16 on four spawned gloo ranks at a tiny size (its small plan)
    tpp = chip_smoke.tp_path(cpu, "cpu", chip_smoke.tp_plan("cpu", True))
    assert tpp["gloo"]["restored_rel"] <= chip_smoke.TP_RESTORE_RTOL
    assert not any(chip_smoke.launch_counts().values())
keep.cleanup()
print("HYGIENE-OK", len(names))
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO / "src"), str(REPO)] +
        ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def test_port_imports_no_jax_and_runs_on_cpu():
    res = subprocess.run([sys.executable, "-c", HYGIENE], env=_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "HYGIENE-OK" in res.stdout


@pytest.mark.parametrize("path", sorted(
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py"]
    + list((REPO / "scripts").glob("torch_*.py"))
    + list((REPO / "examples").glob("torch_*.py"))),
    ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            assert m.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                f"{path}:{node.lineno} imports {m}"


# Runs a script of scripts/ or examples/ in a fresh interpreter where importing jax or
# repro fails outright.
SCRIPT = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
path, *argv = sys.argv[1:]
sys.argv = [path] + argv
try:
    runpy.run_path(path, run_name="__main__")
except SystemExit as e:
    assert not e.code, e.code
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, mod in sys.modules.items() if mod is not None)
print("SCRIPT-OK")
"""


@pytest.mark.parametrize("argv", [
    ["scripts/torch_check_engines.py", "--device", "cpu", "--serving",
     "--obs"],
    ["scripts/torch_serve_model.py", "--model",
     "tests/fixtures/xgb_multiclass.json", "--n-classes", "3", "--engine",
     "qs", "--device", "cpu", "--explain", "--n-requests", "64"],
    ["scripts/torch_make_experiments_tables.py", "--dir",
     "tests/fixtures/dryrun_torch"],
    ["examples/torch_quickstart.py", "--device", "cpu", "--n", "600",
     "--n-trees", "4", "--max-leaves", "8"],
], ids=["check_engines", "serve_model", "make_experiments_tables",
        "quickstart"])
def test_scripts_import_no_jax_and_run_on_cpu(argv):
    res = subprocess.run([sys.executable, "-c", SCRIPT] + argv, env=_env(),
                         cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    assert "SCRIPT-OK" in res.stdout and "FAIL" not in res.stdout


TRAIN = r"""
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.modules["msgpack"] = None
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("repro_torch.launch.train", run_name="__main__",
                 alter_sys=True)
assert not any(m in ("jax", "msgpack") or m.startswith(("jax.", "repro."))
               for m, mod in sys.modules.items() if mod is not None)
print("TRAIN-OK")
"""


def test_train_launcher_runs_without_jax_or_msgpack(tmp_path):
    """``python -m repro_torch.launch.train`` trains, checkpoints and
    resumes where importing jax, repro or msgpack fails outright."""
    argv = ["--reduced", "--steps", "2", "--batch", "2", "--seq-len", "32",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
            "--opt-state", "int8", "--compress-grads", "--device", "cpu"]
    for steps in ("2", "3"):
        argv[2] = steps
        res = subprocess.run([sys.executable, "-c", TRAIN] + argv,
                             env=_env(), cwd=REPO, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        assert "TRAIN-OK" in res.stdout
    assert sorted(os.listdir(tmp_path / "ck"))[-1] == "step_00000003"


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """Without CUDA the script exits non-zero and prints no result; so
    does a copy of it alone in an empty directory."""
    runs = [(REPO / "chip_smoke.py", REPO)]
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", alone)
    runs.append((alone, tmp_path))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for script, cwd in runs:
        if script.parent == REPO and _has_cuda():
            continue
        res = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             env=env, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode != 0, (script, res.stdout[-2000:])
        assert '"ok": true' not in res.stdout


def _has_cuda() -> bool:
    import torch
    return torch.cuda.is_available()
