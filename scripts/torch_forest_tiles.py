"""Time the port's row-tile forest kernels built from one or more source
trees, in turns, on a CUDA card.

    PYTHONPATH=src python scripts/torch_forest_tiles.py \
        [--kernels bitmm,gemm,cascade] [--clusters 2,3,4,8] [DIR ...]

Each DIR is a ``kernels/csrc`` directory.  Inside a checkout of this
repository (``<root>/src/repro_torch/kernels/csrc``) that checkout's own
package is imported, so its wrappers launch its kernels whatever their C
interface; any other directory holds sources with the C interface of
this checkout's ``csrc``, which this checkout's wrappers then launch.
With no DIR this checkout's ``csrc`` is the only one.  For each DIR in
turn (the list, then the list reversed: A, B, B, A) the script builds
the kernels, checks each against its plain version (bit-exact on the
int16 forests) and times it by replaying 50 launches from one CUDA graph
(the device's time).

 * ``bitmm``, ``gemm``: the MSN shape (T = 1024, L = 64, d = 136, C = 1)
   with B = 1024 and the served batch of 455 rows, and the mnist
   cascade's width (T = 512, L = 64, d = 784, C = 10, B = 1024).
 * ``cascade``: ``cascade_qs_forward`` on the mnist cascade of
   ``chip_smoke.py`` (a 512 x 64 random forest trained on mnist, int16,
   stages 16/64/256/512, ``MarginGate(0.5)``, the gate its calibration
   picks; rows from the test half it serves) at B = 1024 and at the
   served bucket of 512 rows, for each cluster size of ``--clusters``
   where the tree's wrapper has ``cascade_layout`` (else once, its own
   design); there also, at B = 1024 and the wrapper's own cluster, with
   a gate that never fires (the gates' cost) and as one stage of all 512
   trees (the stage boundaries' cost); and ``qs_forward`` over all 512
   trees on the same rows.

Run from the repository root.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPS = 50
HERE_SRC = Path(__file__).resolve().parents[1] / "src"
# (label, n_trees, n_leaves, n_features, n_classes, batch)
SHAPES = [("msn B=1024", 1024, 64, 136, 1, 1024),
          ("msn B=455", 1024, 64, 136, 1, 455),
          ("mnist-width B=1024", 512, 64, 784, 10, 1024)]
CASCADE_FOREST = (512, 64)
CASCADE_STAGES = (16, 64, 256, 512)
CASCADE_GATE = 0.5
CASCADE_BATCHES = (1024, 512)


class Tree:
    """The ``repro_torch`` package that launches the kernels of ``csrc``:
    the checkout holding it, or this checkout with its sources swapped.
    Importing one drops every module of the previous one."""

    path = None          # the sys.path entry of the tree imported last

    def __init__(self, csrc: Path):
        own = (csrc.parent / "cascade_kernel.py").exists()
        src = csrc.parents[2] if own else HERE_SRC
        for name in [n for n in sys.modules
                     if n == "repro_torch" or n.startswith("repro_torch.")]:
            del sys.modules[name]
        if Tree.path is not None:
            sys.path.remove(Tree.path)
        Tree.path = str(src)
        sys.path.insert(0, Tree.path)
        self.name = src.parent.name if own else str(csrc)
        self.core = importlib.import_module("repro_torch.core")
        self.build = importlib.import_module("repro_torch.kernels.build")
        self.ops = importlib.import_module("repro_torch.kernels.ops")
        self.qk = importlib.import_module(
            "repro_torch.kernels.quickscorer_kernel")
        self.gk = importlib.import_module(
            "repro_torch.kernels.gemm_forest_kernel")
        self.ck = importlib.import_module(
            "repro_torch.kernels.cascade_kernel")
        self.cascade = importlib.import_module("repro_torch.cascade")
        if not own:
            self.build.CSRC = csrc

    def forest(self, forest):
        """``forest`` (a ``Forest`` of any tree) as this tree's ``Forest``."""
        return self.core.Forest(**{f.name: getattr(forest, f.name)
                                   for f in dataclasses.fields(forest)})


def device_ms(fn) -> float:
    """Milliseconds per call: REPS calls captured in one CUDA graph,
    replayed and timed by CUDA events after an eager warm-up."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def tile_cases(tree, msn, device):
    """(label, engine, kernel, plain version, x, arrays, keyword arguments)
    of the bitmm and gemm kernels at SHAPES."""
    core, ops = tree.core, tree.ops
    quant = core.QuantSpec(bits=16, int_accum=True)
    cases = []
    for label, T, L, d, C, B in SHAPES:
        forest = core.random_forest_ir(T, L, d, n_classes=C, seed=0)
        X = msn.X_test[:B] if d == msn.X_test.shape[1] else \
            np.random.default_rng(0).normal(0, 1.3, size=(B, d))
        qf = core.quantize_forest(forest, X, quant)
        x = torch.from_numpy(core.quantize_inputs(qf, X).astype(
            np.float32)).to(device)
        for engine in ("bitmm", "gemm"):
            kw = dict(out_dtype=ops._out_dtype(qf, 8))
            if engine == "bitmm":
                arrays, bits, npack = ops._bitmm_arrays(qf, 8)
                kw.update(bits=bits, npack=npack, n_leaves=qf.n_leaves)
                fns = tree.qk.qs_bitmm_forward, tree.qk.qs_bitmm_forward_reference
            else:
                arrays = ops._gemm_arrays(qf, 8)
                fns = tree.gk.gemm_forward, tree.gk.gemm_forward_reference
            arrays = tuple(torch.from_numpy(a).to(device) for a in arrays)
            cases.append((label, engine, *fns, x, arrays, kw))
    return cases


def mnist_cascade(tree):
    """The trained int16 mnist forest of chip_smoke.py and the rows its
    cascade serves."""
    from repro_torch.data import datasets
    from repro_torch.trees.random_forest import (RandomForest,
                                                 RandomForestConfig)
    mnist = datasets.make_mnist()
    n_trees, max_leaves = CASCADE_FOREST
    rf = RandomForest(RandomForestConfig(n_trees=n_trees,
                                         max_leaves=max_leaves, seed=0))
    forest = tree.core.from_random_forest(rf.fit(mnist.X_train,
                                                 mnist.y_train))
    qf = tree.core.quantize_forest(forest, mnist.X_train, tree.core.QuantSpec(
        bits=16, int_accum=True))
    n_cal = len(mnist.X_test) // 2
    rows = np.tile(mnist.X_test[n_cal:], (-(-max(CASCADE_BATCHES)
                                            // (len(mnist.X_test) - n_cal)),
                                          1))
    return qf, rows


def cascade_operands(tree, qf, stages, threshold, device):
    """(stage-concatenated arrays, keyword arguments) of
    ``cascade_qs_forward`` for ``qf`` under ``MarginGate(threshold)``."""
    policy = tree.cascade.MarginGate(threshold)
    policy.prepare(qf, stages)
    fn = tree.ops.cuda_fused_cascade_qs(qf, stages, policy, block_t=8,
                                        device=device)
    return fn, dict(stage_bounds=fn.stage_bounds, policy=policy,
                    inv_scale=1.0 / tree.core.leaf_scale(qf),
                    out_dtype=fn.out_dtype)


def checked_ms(tree, label, x, fn, kw) -> float:
    """Device ms of ``cascade_qs_forward`` on these operands, after
    checking one call against its plain version (exit stages and int16
    scores identical)."""
    valid = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
    want = tree.ck.cascade_qs_forward_reference(x, valid, *fn.arrays, **kw)

    def call():
        return tree.ck.cascade_qs_forward(x, valid, *fn.arrays, **kw)
    got = call()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError(f"{tree.name} {label}: kernel != plain version")
    return device_ms(call)


def cascade_runs(tree, qforest, rows, clusters, device):
    """(label, device ms) pairs timing ``cascade_qs_forward`` at each batch
    of CASCADE_BATCHES and cluster size (where the tree has
    ``cascade_layout``), with a never-firing gate and as one stage, and
    ``qs_forward`` over all trees; each call is first checked against its
    plain version."""
    qf = tree.forest(qforest)
    ck, ops, core = tree.ck, tree.ops, tree.core
    fn, kw = cascade_operands(tree, qf, CASCADE_STAGES, CASCADE_GATE, device)
    qs_arrays = tuple(torch.from_numpy(a).to(device)
                      for a in ops._qs_arrays(qf, 8))
    layout = getattr(ck, "cascade_layout", None)
    runs = []
    if layout:
        shape = (qf.n_features, fn.arrays[0].shape[1],
                 fn.arrays[2].shape[-1], qf.n_leaves, qf.n_classes,
                 int(fn.out_dtype == torch.int32))
        held = {g: ck.resident_clusters(dataclasses.replace(
            layout(*shape[:3], shape[4]), cluster=g), *shape)
            for g in range(1, 9)}
        print(f"{tree.name}: the card holds clusters of G blocks at the "
              f"mnist shape (cudaOccupancyMaxActiveClusters) {held}; the "
              f"wrapper's cluster G={ck._card_layout(0, *shape).cluster}")
    for B in CASCADE_BATCHES:
        x = torch.from_numpy(core.quantize_inputs(qf, rows[:B]).astype(
            np.float32)).to(device)
        _, exits = ck.cascade_qs_forward_reference(
            x, torch.ones(B, dtype=torch.bool, device=device), *fn.arrays,
            **kw)
        reach = [int((exits >= k).sum()) for k in range(len(CASCADE_STAGES))]
        for G in clusters if layout else [None]:
            if G is not None:
                ck.cascade_layout = (lambda *a, G=G, **k: dataclasses.replace(
                    layout(*a, **k), cluster=G))
                ck._card_layout.cache_clear()
            label = f"cascade B={B} G={G or 'own'} reach {reach}"
            runs.append((label, checked_ms(tree, label, x, fn, kw)))
        if layout:
            ck.cascade_layout = layout
            ck._card_layout.cache_clear()
        if layout and B == max(CASCADE_BATCHES):
            for label, stages, threshold in (
                    ("gate never fires", CASCADE_STAGES, np.inf),
                    ("one stage", CASCADE_STAGES[-1:], CASCADE_GATE)):
                label = f"cascade B={B} own G {label}"
                runs.append((label, checked_ms(
                    tree, label, x, *cascade_operands(tree, qf, stages,
                                                      threshold, device))))
        qs = tree.qk.qs_forward
        got = qs(x, *qs_arrays, out_dtype=fn.out_dtype)
        if not torch.equal(got, tree.qk.qs_forward_reference(
                x, *qs_arrays, out_dtype=fn.out_dtype)):
            raise AssertionError(f"{tree.name} qs_forward B={B}: kernel != "
                                 "plain version")
        runs.append((f"qs_forward all {qf.n_trees} trees B={B}",
                     device_ms(lambda: qs(x, *qs_arrays,
                                          out_dtype=fn.out_dtype))))
    return runs


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*", type=Path)
    ap.add_argument("--kernels", default="bitmm,gemm,cascade")
    ap.add_argument("--clusters", default="2,3,4,8")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    kernels = set(args.kernels.split(","))
    clusters = [int(g) for g in args.clusters.split(",")]
    dirs = [d.resolve() for d in args.dirs] or \
        [HERE_SRC / "repro_torch" / "kernels" / "csrc"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    tree = Tree(dirs[0])
    msn = importlib.import_module("repro_torch.data.datasets").make_msn()
    cascade = mnist_cascade(tree) if "cascade" in kernels else None
    times = {}
    for csrc in dirs + dirs[::-1] if len(dirs) > 1 else dirs:
        tree = Tree(csrc)
        if kernels & {"bitmm", "gemm"}:
            for label, engine, kernel, plain, x, arrays, kw in tile_cases(
                    tree, msn, device):
                if engine not in kernels:
                    continue
                got = kernel(x, *arrays, **kw)
                if not torch.equal(got, plain(x, *arrays, **kw)):
                    raise AssertionError(f"{csrc} {engine} {label}: kernel "
                                         "!= plain version")
                ms = device_ms(lambda: kernel(x, *arrays, **kw))
                times.setdefault(f"{engine} {label}", []).append(
                    (tree.name, ms))
        if cascade is not None:
            for label, ms in cascade_runs(tree, *cascade, clusters, device):
                times.setdefault(label, []).append((tree.name, ms))
    for label, runs in times.items():
        print(f"{label} int16: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in runs)
            + f" (device, graph replay) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
