#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It imports ``repro_torch`` from ``src/`` and nothing of ``repro``
or JAX.  Phases:

 1. the software and the card (``nvidia-smi`` name and power limit);
 2. build every kernel of the path from ``src/repro_torch/kernels/csrc``;
 3. hold each kernel against its plain torch version on the card, at the
    kernel tests' shape sweep and at the full-width shape, float and
    int16-quantized (int-accum: bit-exact), and against the numpy oracle;
 4. the main path at full width: an MSN-shaped ranking forest (1024 trees
    × 64 leaves × 136 features), quantized int16 with int-accum and
    calibrated on MSN rows, compiled with ``backend="cuda"`` and served
    through ``ForestServer(max_batch=1024)``; served output must equal
    synchronous ``predict``, and the kernel's launches the batches.  Then
    a trained ``magic`` random forest, served quantized, whose accuracy
    may fall at most ``ACCURACY_MARGIN_PP`` below its float forest's;
 5. time each kernel and its plain version with CUDA events beside the
    least time the card could take for the same work.

It prints one JSON line of kernel records, the card's line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is never printed; so it is without a
CUDA device, and where ``src/repro_torch`` is missing.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

from repro_torch import core  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.inference import ForestServer  # noqa: E402
from repro_torch.kernels import build, quickscorer_kernel  # noqa: E402
from repro_torch.kernels.ops import _out_dtype, _qs_arrays  # noqa: E402
from repro_torch.kernels.quickscorer_kernel import (  # noqa: E402
    qs_forward, qs_forward_reference)
from repro_torch.trees.random_forest import (  # noqa: E402
    RandomForest, RandomForestConfig)

# (n_trees, n_leaves, n_features, n_classes, batch) — tests/test_kernels.py
SHAPE_SWEEP = [
    (4, 8, 4, 1, 16),
    (8, 16, 6, 1, 64),
    (12, 32, 10, 3, 96),
    (6, 64, 8, 2, 33),
    (16, 32, 784, 10, 40),
    (3, 16, 5, 1, 1),
]
# benchmarks/bench_engines.py full scale: MSN-shaped ranking forest
FULL = (1024, 64, 136, 1, 1024)
BLOCK_T = 8
MAX_BATCH = 1024
N_REQUESTS = 4096
ARRIVAL_RATE_HZ = 250_000.0      # virtual clock: ~500-row batches at 2 ms
QUANT = core.QuantSpec(bits=16, int_accum=True)
# Float kernel vs plain version: the same f32 leaves summed in another
# order.  At the sweep's <= 16 trees the reference's own rtol 1e-5 /
# atol 1e-6 holds; at 1024 trees of |leaf| ~ 1 the rounding of two
# orders is a random walk of ~sqrt(T)*2^-24*|partial| ~ 1e-4, so the
# full-width atol is 1e-3.  Int-accum forests must be bit-exact.
RTOL, ATOL, ATOL_FULL = 1e-5, 1e-6, 1e-3
# against the float64 numpy oracle (tests/test_kernels.py:36)
ORACLE_RTOL, ORACLE_ATOL = 1e-4, 1e-5
# the paper calls int16 quantization's accuracy cost "neglectable": held
# here to at most half a percentage point on magic's 1200 test rows
ACCURACY_MARGIN_PP = 0.5
# H100 SXM datasheet peaks: HBM bytes/s, and the
# non-tensor f32 rate, which bounds the kernel's 32-bit compare/logic ops
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_inputs(forest, X, device):
    """The kernel's operands for ``forest`` on rows ``X``, on ``device``."""
    arrays = tuple(torch.from_numpy(a).to(device)
                   for a in _qs_arrays(forest, BLOCK_T))
    xq = core.quantize_inputs(forest, np.asarray(X)).astype(np.float32)
    return torch.from_numpy(xq).to(device), arrays, _out_dtype(forest,
                                                               BLOCK_T)


def compare_kernel(forest, X, device, atol: float) -> float:
    """Kernel vs plain version vs numpy oracle on the same inputs; returns
    the kernel's largest absolute difference from the plain version."""
    x, arrays, out_dtype = kernel_inputs(forest, X, device)
    got = qs_forward(x, *arrays, out_dtype=out_dtype)
    ref = qs_forward_reference(x, *arrays, out_dtype=out_dtype)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = float((got.double() - ref.double()).abs().max())
    shape = (forest.n_trees, forest.n_leaves, forest.n_features,
             forest.n_classes, X.shape[0])
    if out_dtype == torch.int32:
        if not torch.equal(got, ref):
            raise AssertionError(f"{shape} int-accum: kernel != plain "
                                 f"version (max |diff| {err})")
    elif not torch.allclose(got, ref, rtol=RTOL, atol=atol):
        raise AssertionError(f"{shape} float: kernel vs plain version "
                             f"max |diff| {err} > atol {atol}")
    # the oracle traverses in float64 with x <= t; fed the same f32 (or
    # quantized) rows it takes the same branches
    scale = core.leaf_scale(forest)
    want = forest.predict_oracle(x.cpu().numpy().astype(
        np.float64 if out_dtype == torch.float32 else forest.threshold.dtype))
    np.testing.assert_allclose(got.cpu().numpy() / scale, want / scale,
                               rtol=ORACLE_RTOL,
                               atol=max(ORACLE_ATOL, atol),
                               err_msg=f"{shape} vs numpy oracle")
    return err


def serve(pred, rows, *, max_batch=MAX_BATCH, rate_hz=ARRIVAL_RATE_HZ,
          seed=0):
    """Serve ``rows`` one request each through a ``ForestServer`` on a
    virtual clock (seeded Poisson arrivals); returns the results in
    request order and the server."""
    server = ForestServer(pred, max_batch=max_batch, max_wait_ms=2.0)
    arrivals = np.cumsum(np.random.default_rng(seed).exponential(
        1.0 / rate_hz, size=len(rows)))
    reqs = []
    for row, t in zip(rows, arrivals):
        reqs.append(server.submit(row, arrival_s=float(t)))
        server.poll(now_s=float(t))
    server.flush(now_s=float(arrivals[-1]) + 2e-3)
    if any(r.result is None for r in reqs):
        raise AssertionError("a request was never answered")
    return np.stack([r.result for r in reqs]), server


def main_path(forest, X_calib, rows, device):
    """Quantize → compile_forest(backend="cuda") → serve; the launches of
    ``qs_forward`` are counted over exactly this run and must equal the
    batches served."""
    qs_forward.launches = 0
    qforest = core.quantize_forest(forest, X_calib, QUANT)
    pred = core.compile_forest(qforest, engine="bitvector", backend="cuda",
                               device=device)
    served, server = serve(pred, rows)
    launches = qs_forward.launches
    if not np.array_equal(served, pred.predict(rows)):
        raise AssertionError("served output != synchronous predict")
    if not np.isfinite(served).all() or \
            served.shape != (len(rows), forest.n_classes):
        raise AssertionError(f"served output shape {served.shape} or "
                             "non-finite values")
    # on the card every batch is one launch; on the CPU (tests) none is
    if device.type == "cuda" and launches != server.stats.n_batches:
        raise AssertionError(f"qs_forward launched {launches} times for "
                             f"{server.stats.n_batches} batches")
    return pred, server, launches


def magic_accuracy(device, n_trees=128, max_leaves=64):
    """Train a magic RF; serve it quantized; float vs quantized accuracy."""
    ds = datasets.make_magic()
    rf = RandomForest(RandomForestConfig(n_trees=n_trees,
                                         max_leaves=max_leaves, seed=0))
    forest = core.from_random_forest(rf.fit(ds.X_train, ds.y_train))
    fpred = core.compile_forest(forest, backend="cuda", device=device)
    acc_float = float((fpred.predict_class(ds.X_test) == ds.y_test).mean())
    qforest = core.quantize_forest(forest, ds.X_train, QUANT)
    qpred = core.compile_forest(qforest, backend="cuda", device=device)
    before = qs_forward.launches
    served, server = serve(qpred, ds.X_test)
    if device.type == "cuda" and \
            qs_forward.launches - before != server.stats.n_batches:
        raise AssertionError("magic: kernel launches != served batches")
    acc_quant = float((served.argmax(axis=1) == ds.y_test).mean())
    if acc_quant < acc_float - ACCURACY_MARGIN_PP / 100:
        raise AssertionError(f"magic int16 accuracy {acc_quant:.4f} falls "
                             f"more than {ACCURACY_MARGIN_PP} pp below "
                             f"float {acc_float:.4f}")
    return acc_float, acc_quant, len(ds.y_test)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after two warm-up calls."""
    fn(), fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def qs_bound(x, arrays, out_dtype):
    """Least time for ``qs_forward`` on these operands: each input read
    and the output written once at the HBM rate, or one compare plus a
    select and an AND per leafidx word for every (row, tree, node), plus
    one add per (row, tree, class), at the ALU rate — the larger."""
    feat, _, masks, _, leaf_val = arrays
    B = x.shape[0]
    T, N = feat.shape
    W = masks.shape[-1]
    C = leaf_val.shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x,) + arrays) \
        + B * C * torch.tensor([], dtype=out_dtype).element_size()
    ops = B * T * N * (1 + 2 * W) + B * T * C
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes, ops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = card_line()

    # 1. software and card
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(f"card: {card}")

    # 2. build from the repo's sources
    t0 = time.perf_counter()
    paths = build.build(["qs_forward"])
    print(f"built {', '.join(str(p) for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    regs = [ln.strip() for ln in build.build_log("qs_forward").splitlines()
            if "registers" in ln]
    print(f"ptxas: {len(regs)} functions; {regs[0] if regs else ''}")

    # 3. kernel vs plain version vs oracle
    for T, L, d, C, B in SHAPE_SWEEP:
        forest = core.random_forest_ir(T, L, d, n_classes=C, seed=T,
                                       full=(T % 2 == 0))
        X = np.random.default_rng(B).normal(0, 1.3, size=(B, d))
        err = compare_kernel(forest, X, device, ATOL)
        qforest = core.quantize_forest(forest, X, QUANT)
        compare_kernel(qforest, X, device, ATOL)
        print(f"qs_forward T={T} L={L} d={d} C={C} B={B}: float max|diff| "
              f"{err:.3g} (rtol {RTOL}, atol {ATOL}); int16 bit-exact")
    T, L, d, C, B = FULL
    msn = datasets.make_msn()
    full = core.random_forest_ir(T, L, d, n_classes=C, seed=0)
    rows_full = msn.X_test[:B]
    err_float = compare_kernel(full, rows_full, device, ATOL_FULL)
    qfull = core.quantize_forest(full, msn.X_train, QUANT)
    err_quant = compare_kernel(qfull, rows_full, device, ATOL_FULL)
    print(f"qs_forward full width T={T} L={L} d={d} C={C} B={B}: float "
          f"max|diff| {err_float:.3g} (atol {ATOL_FULL}); int16 "
          f"bit-exact ({err_quant})")

    # 4. the main path at full width, then a trained model's accuracy
    rows = np.concatenate([msn.X_test, msn.X_train])[:N_REQUESTS]
    t0 = time.perf_counter()
    pred, server, launches = main_path(full, msn.X_train, rows, device)
    wall = time.perf_counter() - t0
    stats = server.stats.summary()
    print(f"main path: {pred.plan.describe()}")
    print(f"served {stats['n_requests']} requests in {stats['n_batches']} "
          f"batches (mean {stats['mean_batch']:.1f} rows), qs_forward "
          f"launches {launches}; served == predict; {wall:.2f} s host wall "
          "incl. quantize+compile")
    print(f"per batch, host clock: predict (quantize rows, pad, copy in, "
          f"kernel, copy out) p50 {stats['compute_p50_ms']:.3f} ms, max "
          f"{max(server.stats.compute_ms):.3f} ms [{card}]")
    acc_float, acc_quant, n_test = magic_accuracy(device)
    print(f"magic RF 128x64: float accuracy {acc_float:.4f}, int16 served "
          f"{acc_quant:.4f} on {n_test} rows (margin "
          f"{ACCURACY_MARGIN_PP} pp)")

    # 5. timings at the main path's full-width kernel shape
    x, arrays, out_dtype = kernel_inputs(pred.forest, rows[:B], device)
    ms = cuda_ms(lambda: qs_forward(x, *arrays, out_dtype=out_dtype), 200)
    plain_ms = cuda_ms(lambda: qs_forward_reference(
        x, *arrays, out_dtype=out_dtype), 10)
    bound_ms, bound_by, nbytes, ops = qs_bound(x, arrays, out_dtype)
    fx, farrays, fdtype = kernel_inputs(full, rows[:B], device)
    float_ms = cuda_ms(lambda: qs_forward(fx, *farrays, out_dtype=fdtype),
                       200)
    print(f"qs_forward B={B} T={T} L={L} d={d} int16/int32-accum: kernel "
          f"{ms:.4f} ms, plain torch {plain_ms:.4f} ms, bound {bound_ms:.5f}"
          f" ms by {bound_by} ({nbytes} bytes, {ops} ops); no single "
          f"PyTorch call computes this function [{card}]")
    print(f"qs_forward same shape, float forest (f32 accumulation): kernel "
          f"{float_ms:.4f} ms [{card}]")

    print(json.dumps({"kernels": [{
        "name": "qs_forward", "route": "cuda",
        "source": quickscorer_kernel.SOURCE,
        "replaces": quickscorer_kernel.REPLACES,
        "launches": launches, "max_abs_err": max(err_float, err_quant),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
