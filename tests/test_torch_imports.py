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
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
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
split = chip_smoke.host_split(res["fused"], ds.X_test[60:100],
                              torch.device("cpu"), reps=2)
assert split["bucket"] == 128 and min(split.values()) >= 0
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
from repro_torch.configs import get_config
cfg = get_config(chip_smoke.LM_ARCH).reduced()
lm = chip_smoke.lm_path(cfg, chip_smoke.lm_prompts(cfg, 2, 20), 3,
                        torch.device("cpu"))
assert lm["launches"] == 0 and lm["tokens"].shape == (2, 23)
for shape in chip_smoke.FLASH_SWEEP[:2]:
    for dt in (torch.float32, torch.bfloat16):
        assert chip_smoke.compare_flash(*shape, dt, torch.device("cpu")) == 0
assert 120 * chip_smoke.visible_pairs(1024, 1024, True) == 62_976_000
if not torch.cuda.is_available():
    try:
        core.compile_forest(forest)
    except RuntimeError as e:
        assert "device='cpu'" in str(e)
    else:
        raise AssertionError("compile_forest ran without a CUDA device")
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
    [p for p in PORT.rglob("*.py")] + [REPO / "chip_smoke.py"]),
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
