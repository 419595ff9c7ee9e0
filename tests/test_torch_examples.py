"""The port's examples (``examples/torch_*.py``) on the CPU at small sizes,
each through its ``main([... "--device", "cpu"])``, on one intra-op
thread.

The forest examples are held against the same steps run through the
reference's API (``repro``) at the same sizes and seeds, as
``examples/quickstart.py``, ``serve_forest.py`` and ``ranking_e2e.py``
take them: the trained accuracy and every engine's accuracy equal, the
quantized forest's scores bit for bit, NDCG@10 per engine equal, and the
served requests, batches and accuracy equal on the same virtual-clock
arrivals (both servers over the one pinned engine ``qs``, so neither
sweeps the engine matrix).

The training examples (``torch_train_lm.py``, ``torch_elastic_restart.py``)
are held to their own checks only: the loss falls, and the restarted run
stays within 1e-3 of the uninterrupted one.  The reference's ``Trainer``
is red under this JAX (ROADMAP Queue C's reference-side reds), and
``tests/test_torch_trainer.py`` already holds the port's ``Trainer`` step
to the reference's.
"""
import importlib.util
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import core as ref_core  # noqa: E402
from repro.data import datasets as ref_datasets  # noqa: E402
from repro.inference.server import ForestServer as RefServer  # noqa: E402
from repro.trees.gradient_boosting import (  # noqa: E402
    GradientBoosting as RefGB, GradientBoostingConfig as RefGBConfig)
from repro.trees.random_forest import (  # noqa: E402
    RandomForest as RefRF, RandomForestConfig as RefRFConfig)
from repro_torch import core  # noqa: E402
from repro_torch.core import engine_select  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.trees.random_forest import (  # noqa: E402
    RandomForest, RandomForestConfig)

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "examples")
# (rows, trees, leaves) of the small forests
MAGIC, MNIST, MSN = (600, 8, 8), (600, 8, 8), (2600, 12, 8)
N_REQUESTS = 300


@pytest.fixture(autouse=True)
def one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _example(name):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sizes(n, trees, leaves):
    return ["--n", str(n), "--n-trees", str(trees), "--max-leaves",
            str(leaves), "--device", "cpu"]


def _ref_rf(name, n, trees, leaves):
    ds = ref_datasets.load(name, n=n)
    rf = RefRF(RefRFConfig(n_trees=trees, max_leaves=leaves, seed=0))
    return ds, rf.fit(ds.X_train, ds.y_train)


def test_quickstart_matches_reference():
    """Every engine's accuracy, float and int16, equals the reference's;
    the kernel step's quantized scores (the kernel's plain version here)
    equal the reference's bitvector engine's bit for bit."""
    got = _example("torch_quickstart").main(_sizes(*MAGIC))
    ds, rf = _ref_rf("magic", *MAGIC)
    assert got["trained_acc"] == float((rf.predict(ds.X_test)
                                        == ds.y_test).mean())
    forest = ref_core.from_random_forest(rf)
    qforest = ref_core.quantize_forest(forest, ds.X_train)
    assert got["forest"] == {"n_trees": forest.n_trees,
                             "n_leaves": forest.n_leaves,
                             "n_classes": forest.n_classes,
                             "n_words": forest.n_words}
    want = {}
    for f, tag in ((forest, ""), (qforest, "q")):
        for engine in ref_core.ENGINES:
            out = np.asarray(ref_core.compile_forest(f, engine=engine)
                             .predict(ds.X_test))
            want[tag + engine] = float((out.argmax(1) == ds.y_test).mean())
    assert got["accuracy"] == want
    assert got["kernel_max_abs_diff"] == 0.0
    pds = datasets.load("magic", n=MAGIC[0])
    prf = RandomForest(RandomForestConfig(n_trees=MAGIC[1],
                                          max_leaves=MAGIC[2], seed=0))
    pq = core.quantize_forest(core.from_random_forest(
        prf.fit(pds.X_train, pds.y_train)), pds.X_train)
    X = ds.X_test[:256]
    np.testing.assert_array_equal(
        np.asarray(core.compile_forest(pq, engine="bitvector",
                                       backend="cuda",
                                       device="cpu").predict(X)),
        np.asarray(ref_core.compile_forest(qforest, engine="bitvector")
                   .predict(X)))


def test_serve_forest_matches_reference(tmp_path, monkeypatch):
    """Requests, batches and accuracy equal the reference ``ForestServer``'s
    on the same arrivals; a second run answers from the cache file."""
    monkeypatch.setenv("REPRO_ENGINE_CACHE", str(tmp_path / "cache.json"))
    engine_select.clear_cache()
    argv = _sizes(*MNIST) + ["--n-requests", str(N_REQUESTS),
                             "--engines", "qs"]
    mod = _example("torch_serve_forest")
    got = mod.main(argv)
    engine_select.clear_cache()                     # memory only: the file
    again = mod.main(argv)
    assert (got["from_cache"], again["from_cache"]) == (False, True)
    assert got["engine"] == again["engine"] == "qs"

    ds, rf = _ref_rf("mnist", *MNIST)
    forest = ref_core.quantize_forest(ref_core.from_random_forest(rf),
                                      ds.X_train)
    server = RefServer.from_forest(forest, max_batch=128, max_wait_ms=2.0,
                                   engines=("qs",), cache_path=None)
    rng = np.random.default_rng(0)
    arrivals = np.cumsum(rng.exponential(1 / 5000.0, size=N_REQUESTS))
    rows = rng.integers(0, ds.X_test.shape[0], size=N_REQUESTS)
    correct = total = 0
    done = []
    for at, row in zip(arrivals, rows):
        req = server.submit(ds.X_test[row], arrival_s=at)
        req.label = int(ds.y_test[row])
        done += server.poll(now_s=at)
    done += server.flush(now_s=float(arrivals[-1]))
    for r in done:
        total += 1
        correct += int(np.argmax(r.result)) == r.label
    s = server.stats.summary()
    for run in (got, again):
        assert (run["n_requests"], run["n_batches"], run["served"]) == \
            (s["n_requests"], s["n_batches"], total) == \
            (N_REQUESTS, s["n_batches"], N_REQUESTS)
        assert run["mean_batch"] == s["mean_batch"]
        assert run["accuracy"] == correct / total


def test_ranking_matches_reference():
    """NDCG@10 of the trainer and of every engine, and of the int16
    rapidscorer, equal the reference's."""
    n, trees, leaves = MSN
    mod = _example("torch_ranking_e2e")
    got = mod.main(_sizes(*MSN))
    ds = ref_datasets.load("msn", n=n)
    gb = RefGB(RefGBConfig(n_trees=trees, max_leaves=leaves,
                           objective="l2", learning_rate=0.15, seed=0))
    gb.fit(ds.X_train, ds.y_train)
    assert got["ndcg_trainer"] == float(mod.ndcg_at_k(gb.predict(ds.X_test),
                                                      ds.y_test))
    forest = ref_core.from_gradient_boosting(gb)
    want = {}
    for engine in ref_core.ENGINES:
        scores = np.asarray(ref_core.compile_forest(forest, engine=engine)
                            .predict(ds.X_test))[:, 0]
        want[engine] = float(mod.ndcg_at_k(scores, ds.y_test))
    assert got["ndcg"] == want
    qpred = ref_core.compile_forest(
        ref_core.quantize_forest(forest, ds.X_train), engine="rapidscorer")
    assert got["ndcg_int16_rapidscorer"] == float(mod.ndcg_at_k(
        np.asarray(qpred.predict(ds.X_test))[:, 0], ds.y_test))


def test_train_lm_reduces_the_loss_and_checkpoints(tmp_path):
    """``run_loop`` trains the 14M smollm 30 steps: the last 10 steps'
    mean loss below the first 10's, and a checkpoint at the end."""
    ck = tmp_path / "ck"
    got = _example("torch_train_lm").main([
        "--steps", "30", "--batch", "4", "--seq-len", "32", "--ckpt-dir",
        str(ck), "--device", "cpu"])
    assert got["steps"] == got["final_step"] == 30
    assert got["config"] == "smollm-14m"
    assert got["loss_last10"] < got["loss_first10"]
    assert (ck / "LATEST").read_text().strip().endswith("30")
    assert os.path.isdir(ck / "hb")


def test_elastic_restart_keeps_the_loss_trajectory():
    """Three steps on the shrunken job (accumulation 2) against the
    uninterrupted job's three: within 1e-3 (relative)."""
    got = _example("torch_elastic_restart").main([
        "--batch", "4", "--seq-len", "16", "--device", "cpu"])
    assert got["restored_step"] == 3
    assert got["plan"] == {"dp_size": 1, "accum_steps": 2,
                           "global_batch": 4, "dropped_hosts": [1]}
    assert len(got["restarted"]) == len(got["uninterrupted"]) == 3
    assert got["max_rel_dev"] < 1e-3
