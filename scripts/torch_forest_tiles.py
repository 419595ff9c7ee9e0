"""Time the port's ``qs_bitmm_forward`` and ``gemm_forward`` kernels built
from one or more source directories, in turns, on a CUDA card.

Each directory holds a ``qs_bitmm_forward.cu``, a ``gemm_forward.cu`` and
the header they include (``tile_common.cuh``), with the C interface of
``src/repro_torch/kernels/csrc``; with no argument that directory is the
only one.  For each directory in turn (the list, then the list reversed:
A, B, B, A) the script builds both kernels, checks each against its plain
version on the MSN-shaped int16 forest (bit-exact), and times it by
replaying 50 launches from one CUDA graph (the device's time) at the MSN
shape (T = 1024, L = 64, d = 136, C = 1) with B = 1024 and the served
batch of 455 rows, and at the mnist cascade's width (T = 512, L = 64,
d = 784, C = 10, B = 1024).  Run from the repository root:

    PYTHONPATH=src python scripts/torch_forest_tiles.py [DIR ...]
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch import core
from repro_torch.data import datasets
from repro_torch.kernels import build, ops
from repro_torch.kernels.gemm_forest_kernel import (gemm_forward,
                                                    gemm_forward_reference)
from repro_torch.kernels.quickscorer_kernel import (
    qs_bitmm_forward, qs_bitmm_forward_reference)

REPS = 50
QUANT = core.QuantSpec(bits=16, int_accum=True)
# (label, n_trees, n_leaves, n_features, n_classes, batch)
SHAPES = [("msn B=1024", 1024, 64, 136, 1, 1024),
          ("msn B=455", 1024, 64, 136, 1, 455),
          ("mnist-width B=1024", 512, 64, 784, 10, 1024)]


def use_sources(csrc: Path) -> None:
    """Make the next launches of both kernels libraries built from the
    sources in ``csrc``."""
    build.CSRC = csrc
    for name in ("qs_bitmm_forward", "gemm_forward"):
        build._LOADED.pop(name, None)
    build.build(["qs_bitmm_forward", "gemm_forward"])


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


def operands(engine, forest, X, device):
    """(kernel, plain version, x, arrays, keyword arguments)."""
    xq = core.quantize_inputs(forest, X).astype(np.float32)
    x = torch.from_numpy(xq).to(device)
    kw = dict(out_dtype=ops._out_dtype(forest, 8))
    if engine == "bitmm":
        arrays, bits, npack = ops._bitmm_arrays(forest, 8)
        kw.update(bits=bits, npack=npack, n_leaves=forest.n_leaves)
        fns = qs_bitmm_forward, qs_bitmm_forward_reference
    else:
        arrays = ops._gemm_arrays(forest, 8)
        fns = gemm_forward, gemm_forward_reference
    arrays = tuple(torch.from_numpy(a).to(device) for a in arrays)
    return (*fns, x, arrays, kw)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    dirs = [Path(a).resolve() for a in argv] or [build.CSRC]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    msn = datasets.make_msn()
    cases = []
    for label, T, L, d, C, B in SHAPES:
        forest = core.random_forest_ir(T, L, d, n_classes=C, seed=0)
        X = msn.X_test[:B] if d == msn.X_test.shape[1] else \
            np.random.default_rng(0).normal(0, 1.3, size=(B, d))
        qf = core.quantize_forest(forest, X, QUANT)
        for engine in ("bitmm", "gemm"):
            cases.append((label, engine, operands(engine, qf, X, device)))
    times = {}
    for csrc in dirs + dirs[::-1] if len(dirs) > 1 else dirs:
        use_sources(csrc)
        for label, engine, (kernel, plain, x, arrays, kw) in cases:
            got = kernel(x, *arrays, **kw)
            if not torch.equal(got, plain(x, *arrays, **kw)):
                raise AssertionError(f"{csrc} {engine} {label}: kernel != "
                                     "plain version")
            ms = device_ms(lambda: kernel(x, *arrays, **kw))
            times.setdefault((label, engine), []).append((csrc, ms))
    for (label, engine), runs in times.items():
        print(f"{engine} {label} int16: " + ", ".join(
            f"{csrc.name}/{csrc.parent.name} {ms:.4f} ms"
            for csrc, ms in runs) + f" (device, graph replay) [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
