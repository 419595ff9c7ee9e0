#!/usr/bin/env python3
"""Drive the port's main path on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

From the root of a checkout, on a machine with one CUDA card and the CUDA
toolkit.  It imports ``repro_torch`` from ``src/`` and nothing of ``repro``
or JAX.  Phases:

 1. the software and the card (``nvidia-smi`` name and power limit);
 2. build every kernel of the path from ``src/repro_torch/kernels/csrc``
    (one ``nvcc`` per source, all started together); print each kernel's
    ptxas registers, static shared memory and spills (the mnist cascade's
    ``cascade_qs_forward`` instance must not spill), the HGMMA (wgmma)
    instructions in the SASS of ``flash_forward``'s bf16 kernels and the
    IMMA (int8 mma.sync) instructions in that of ``qs_bitmm_forward``'s and
    ``gemm_forward``'s tile kernels, which must all hold some;
 3. hold each kernel (``qs_forward``, ``qs_bitmm_forward``,
    ``gemm_forward``) against its plain torch version on the card, at the
    kernel tests' shape sweeps and at the full-width shape, float and
    int16-quantized (int-accum: bit-exact), and against the numpy oracle;
 4. the main path at full width: an MSN-shaped ranking forest (1024 trees
    × 64 leaves × 136 features), quantized int16 with int-accum and
    calibrated on MSN rows, compiled with ``backend="cuda"`` for each of
    the engines ``bitvector``, ``bitmm`` and ``gemm`` and served through
    ``ForestServer(max_batch=1024)``; served output must equal synchronous
    ``predict``, each engine's kernel launches the batches (on its
    shared-memory-x route only), and the three engines' served outputs
    must be bit-identical.  Then a trained
    ``magic`` random forest, served quantized, whose accuracy may fall at
    most ``ACCURACY_MARGIN_PP`` below its float forest's;
 5. the cascade slice: hold ``cascade_qs_forward`` against its plain
    version at a shape sweep (margin, proba and bound gates; logit and
    vote leaves; float and int16; invalid rows; two launches
    bit-identical) and at full width; train the reference
    benchmark's largest cascade forest (``RandomForest`` 512 trees x 64
    leaves on mnist, d=784, C=10), quantize it int16 with int-accum,
    calibrate the gate on half the test rows and serve the other half,
    repeated to 4096 requests, through ``compile_forest(...,
    backend="cuda", cascade=CascadeSpec((16, 64, 256), fused=...))`` fused
    (one ``cascade_qs_forward`` launch per batch) and staged (one
    ``qs_forward`` launch per stage with survivors, shared-memory-x route
    only), and the tier-1 fused cascade on ``engine="bitmm"`` and
    ``"gemm"`` (one ``qs_bitmm_forward`` / ``gemm_forward`` launch per
    stage with survivors): all four bit-identical, scores and exit counts,
    served == ``predict``, every fused launch on the x-tile route; a
    disabled gate served fused equals the plain bitvector engine, and
    ``ScoreBoundGate`` keeps every row's class; then one served fused
    batch's host time split into its steps;
 6. the compile slice: the MSN int16 forest written with
    ``io.save_forest`` and compiled from the file at -O2 (``compile_plan(
    path, opt="O2")``) on ``backend="cuda"`` for each kernel engine, served
    (one launch per batch, no other kernel) bit-identical to the -O0
    in-memory compile and to plain torch at -O2; the host ms of each compile
    pass at O0, O1 and O2 and of each optimizer pass; the trained mnist
    forest written as sklearn-shim JSON, compiled int16 at -O2 into a fused
    cascade with a calibrated gate and served (one ``cascade_qs_forward``
    launch per batch) bit-identical to the staged -O2 cascade in plain
    torch, its full -O2 forest equal to -O0; the six golden model files of
    ``tests/fixtures`` on every kernel engine; and ``ForestServer.save`` /
    ``load`` of torch-engine predictors (load → first prediction against
    compile → first prediction), with saving a ``cuda`` predictor refused;
 7. the LM slice: hold ``flash_forward`` against its plain version at the
    reference's sweep (f32, 2e-5), in bf16 (3e-2) and at the served shape
    in both, two launches bit-identical; then serve smollm-360m at full
    width (32 layers, d 960, 15/5 heads, vocab 49152; seeded random
    weights in bf16) through ``LMServer(batch=8, max_len=1057)
    .generate(8 prompts x 1024 tokens, n_new=32)`` on ``backend="cuda"``:
    one ``flash_forward`` launch per attention layer of the one-pass
    prefill, every one on the bf16 ``wgmma`` route, and no other kernel;
    in f32 at the same weights ``cuda`` and
    ``torch`` give the same greedy tokens and close prefill logits, so do
    the bf16 prefill logits, and teacher-forced ``decode_step`` matches
    ``Model.forward``;
 8. time each kernel and its plain version with CUDA events, as an
    eager loop of calls, beside the least time the card could take for
    the same work (the kernels and SDPA also replayed from one CUDA graph,
    the device's time without the host's work per call, in ``device_ms``
    and ``library_device_ms``; ``flash_forward`` also beside
    ``scaled_dot_product_attention``, at the served shape and at
    ``prefill_32k``'s per-sequence shape, S = 32768, and its f32 route
    at the served shape; ``cascade_qs_forward`` beside ``qs_forward``
    over the mnist cascade's 512 trees, with its cluster layout and the
    share of walked pairs that belong to exited rows).

It prints one JSON line of kernel records, the card's line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is never printed; so it is without a
CUDA device, and where ``src/repro_torch`` is missing.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch import core, io, optim  # noqa: E402
from repro_torch.cascade import (CascadeSpec, MarginGate,  # noqa: E402
                                 ProbaGate, ScoreBoundGate, calibrate)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core.engine_select import bucket_batch  # noqa: E402
from repro_torch.core.registry import (as_input_tensor,  # noqa: E402
                                       ensure_feature_column)
from repro_torch.data import datasets  # noqa: E402
from repro_torch.data.tokens import (SyntheticTokens,  # noqa: E402
                                     TokenPipelineConfig)
from repro_torch.inference import ForestServer, LMServer  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.cascade_kernel import (  # noqa: E402
    cascade_layout, cascade_qs_forward, cascade_qs_forward_reference,
    resident_clusters)
from repro_torch.kernels.launch import TILE_ROWS, sm_count  # noqa: E402
from repro_torch.kernels.flash_attention_kernel import (  # noqa: E402
    flash_forward, flash_forward_reference)
from repro_torch.models import Model  # noqa: E402
from repro_torch.kernels.gemm_forest_kernel import (  # noqa: E402
    gemm_forward, gemm_forward_reference)
from repro_torch.kernels.quickscorer_kernel import (  # noqa: E402
    qs_bitmm_forward, qs_bitmm_forward_reference, qs_forward,
    qs_forward_reference)
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
# (n_trees, n_leaves, n_features, n_classes, full, seed) — tests/test_bitmm.py:
# deep unbalanced trees, multiclass, stumps, 22 packed groups at L=128
FOREST_SWEEP = [
    (8, 16, 6, 1, True, 0),
    (6, 64, 8, 1, False, 1),
    (12, 32, 10, 3, False, 2),
    (10, 2, 4, 1, True, 3),
    (4, 128, 5, 2, False, 4),
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
# (n_trees, n_leaves, n_features, n_classes, batch, stages, gate, vote
# leaves) for the cascade kernel: logit leaves through the softmax gate,
# vote leaves through the vote normalization, the bound gate where its
# later stages are short enough to fire (C = 3 and the C = 1 band), wide
# leaves and classes, batches that cross the 32-row tiles (the last two
# rows invalid), a first stage of fewer trees than a cluster has warps, and
# the mnist cascade's shape on a random forest: every entry of
# tests/test_torch_cuda.py's CASCADE_SHAPES, two more batches, and a
# two-word vote forest
CASCADE_SWEEP = [
    (24, 16, 8, 3, 300, (6, 12, 24), MarginGate(0.3), False),
    (24, 16, 8, 3, 129, (6, 12, 24), ProbaGate(0.5), True),
    (24, 16, 8, 3, 300, (6, 12, 24), ProbaGate(0.5), True),
    (24, 16, 8, 3, 300, (20, 22, 24), ScoreBoundGate(), True),
    (24, 16, 8, 1, 77, (20, 22, 24), ScoreBoundGate(0.5, 0.25), False),
    (24, 16, 8, 1, 129, (20, 22, 24), ScoreBoundGate(0.5, 0.25), False),
    (12, 256, 7, 16, 33, (3, 12), MarginGate(0.1), False),
    (24, 16, 8, 3, 77, (3, 12, 24), MarginGate(0.3), False),
    (512, 64, 784, 10, 1024, (16, 64, 256, 512), MarginGate(0.3), False),
    (16, 64, 10, 2, 77, (4, 16), MarginGate(0.2), True),
]
CASCADE_INVALID = 2              # rows of each sweep batch with valid False
# benchmarks/bench_cascade.py:53-60, its largest case: mnist, a random
# forest of 512 trees x 64 leaves, stages (16, 64, 256), calibrated to
# within half a percentage point of the full forest (:75-85)
CASCADE_FOREST = (512, 64)
CASCADE_STAGES = (16, 64, 256, 512)
CASCADE_FLOOR_PP = 0.5
# the tier-1 fused cascade (a device gate around each stage's kernel), on
# the engines whose kernels have no cascade form of their own
CASCADE_TIER1_ENGINES = ("bitmm", "gemm")
# the compile slice: the forests above compiled from model files through
# the optimizer middle-end (O0 is the unoptimized compile), the golden model
# files and their tolerance (tests/test_importers.py:50), and the engines
# whose predictors save and load (plain torch: cuda predictors are rebuilt
# from the forest)
OPT_LEVELS = ("O0", "O1", "O2")
SERVED_OPT = "O2"
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures")
FIXTURE_RTOL, FIXTURE_ATOL = 1e-5, 1e-6
SAVED_ENGINES = ("bitvector", "gemm")
# (B, Sq, Sk, H, K, hd, causal) for flash_forward: tests/test_flash_kernel.py
# :29-35 (MHA, GQA 3:1, MQA, Sq != Sk non-causal, smollm ratios), ragged
# edges, and the dense configs' head dims 96 and 128
FLASH_SWEEP = [
    (1, 32, 32, 4, 4, 8, True),
    (2, 64, 64, 6, 2, 16, True),
    (2, 64, 64, 8, 1, 16, True),
    (1, 48, 96, 4, 4, 8, False),
    (2, 128, 128, 15, 5, 4, True),
    (2, 300, 300, 15, 5, 64, True),
    (1, 77, 131, 4, 2, 96, True),
    (1, 131, 77, 8, 8, 128, False),
]
# the reference's tolerances (tests/test_flash_kernel.py:45, :75): the same
# f32 arithmetic summed in another order; bf16 out
FLASH_TOL_F32, FLASH_TOL_BF16 = 2e-5, 3e-2
# the LM slice: smollm-360m (src/repro/configs/smollm_360m.py), the
# reference serve's default arch, at full width and depth; prefill_32k
# (S 32768, batch 32, models/config.py:160) cut to 8 prompts x 1024
# tokens for the script's time, then 32 greedy tokens
LM_ARCH = "smollm_360m"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 1024, 32
LM_SEED = 0
LONG_S = 32768
# f32 backends differ only in the prefill attention's summation order:
# prefill logits within 1e-3 of the largest |logit|.  bf16: both engines
# round the probabilities to bf16 before the PV product, in other tile
# orders, and 32 layers of bf16 residual carry the difference: within 5%
# of the largest |logit|.  Teacher-forced decode vs forward in f32:
# the reference test's 2e-2 (tests/test_models_smoke.py:92)
LM_LOGIT_TOL_F32, LM_LOGIT_TOL_BF16, LM_DECODE_TOL = 1e-3, 5e-2, 2e-2
LM_TEACHER_STEPS = 16
# H100 SXM datasheet peaks: HBM bytes/s; the non-tensor f32 rate, here
# the rate of every 32-bit compare, logic or integer instruction (twice
# the rate at which the card issues them, so a bound built on it is a
# floor); the dense int8 tensor rate, which bounds the products of 0/1
# conditions with small integers (A in {-1, 0, 1}; byte planes of the
# packed bitmm words), exact in int8 with int32 accumulation
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
FUSED_SDPA = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
              SDPBackend.CUDNN_ATTENTION]


class Kernel:
    """One engine's kernel: its wrapper, plain version and padded operands
    for a forest."""

    def __init__(self, engine, launch, plain, source_name):
        self.engine, self.launch, self.plain = engine, launch, plain
        self.source_name = source_name

    def operands(self, forest):
        """(arrays, keyword arguments) of the wrapper for ``forest``."""
        if self.engine == "bitvector":
            return ops._qs_arrays(forest, BLOCK_T), {}
        if self.engine == "bitmm":
            arrays, bits, npack = ops._bitmm_arrays(forest, BLOCK_T)
            return arrays, dict(bits=bits, npack=npack,
                                n_leaves=forest.n_leaves)
        return ops._gemm_arrays(forest, BLOCK_T), {}

    def work(self, x, arrays):
        """(operations, least seconds) of the function on these operands.

        Every engine: a compare per (row, tree, node) and a leaf add per
        (row, tree, class), one hit per tree.  qs: a predicated AND per
        leafidx word and node, on the ALU (its int8 form, a count of
        clearing nodes per leaf, would take longer).  bitmm: the
        contraction as three int8 products of cond with the packed words'
        byte planes; then per (row, tree, group) two multiply-adds joining
        the planes, the borrow trick's subtract and three-input logic op,
        and a test.  gemm: the int8 product S·A, then an equality test per
        leaf.  Tensor and ALU pipes run side by side, so the least time is
        the larger of their two times."""
        B = x.shape[0]
        T, N = arrays[0].shape
        L, C = arrays[-1].shape[1:]
        if self.engine == "bitvector":
            alu = B * T * N * (1 + arrays[2].shape[-1]) + B * T * C
            return alu, alu / ALU_OPS_PER_S
        if self.engine == "bitmm":
            G = arrays[3].shape[-1]                     # bias (T, G)
            mma, alu = 3 * 2 * B * T * N * G, B * T * (N + 5 * G + C)
        else:
            mma, alu = 2 * B * T * N * L, B * T * (N + L + C)
        return mma + alu, max(mma / INT8_OPS_PER_S, alu / ALU_OPS_PER_S)


KERNELS = [
    Kernel("bitvector", qs_forward, qs_forward_reference, "qs_forward"),
    Kernel("bitmm", qs_bitmm_forward, qs_bitmm_forward_reference,
           "qs_bitmm_forward"),
    Kernel("gemm", gemm_forward, gemm_forward_reference, "gemm_forward"),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def kernel_inputs(kernel, forest, X, device):
    """The kernel's operands for ``forest`` on rows ``X``, on ``device``:
    (x, arrays, keyword arguments with ``out_dtype``)."""
    arrays, kw = kernel.operands(forest)
    arrays = tuple(torch.from_numpy(a).to(device) for a in arrays)
    xq = core.quantize_inputs(forest, np.asarray(X)).astype(np.float32)
    kw["out_dtype"] = ops._out_dtype(forest, BLOCK_T)
    return torch.from_numpy(xq).to(device), arrays, kw


def compare_kernel(kernel, forest, X, device, atol: float) -> float:
    """Kernel vs plain version vs numpy oracle on the same inputs; returns
    the kernel's largest absolute difference from the plain version."""
    x, arrays, kw = kernel_inputs(kernel, forest, X, device)
    out_dtype = kw["out_dtype"]
    got = kernel.launch(x, *arrays, **kw)
    ref = kernel.plain(x, *arrays, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = float((got.double() - ref.double()).abs().max())
    shape = (kernel.source_name, forest.n_trees, forest.n_leaves,
             forest.n_features, forest.n_classes, X.shape[0])
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


def reset_launches() -> None:
    for k in KERNELS:
        k.launch.launches = 0
    cascade_qs_forward.launches = 0
    flash_forward.launches = 0
    for routes in [k.launch.launches_by_route for k in KERNELS] + \
            [cascade_qs_forward.launches_by_route,
             flash_forward.launches_by_route]:
        for route in routes:
            routes[route] = 0


def tile_routes() -> dict:
    """The x-tile routes of the three forest kernels, by engine."""
    return {k.engine: dict(k.launch.launches_by_route) for k in KERNELS}


def launch_counts() -> dict:
    """Every kernel wrapper's launch count, by engine (``"cascade"`` for
    ``cascade_qs_forward``, ``"flash"`` for ``flash_forward``)."""
    counts = {k.engine: k.launch.launches for k in KERNELS}
    counts["cascade"] = cascade_qs_forward.launches
    counts["flash"] = flash_forward.launches
    return counts


def main_path(forest, X_calib, rows, device, engine="bitvector"):
    """Quantize → compile_forest(engine, backend="cuda") → serve.  Every
    kernel's launch count is set to 0 just before and read just after;
    the engine's kernel must have launched once per served batch and the
    others not at all.  Returns (predictor, served output, server, the
    engine's launches)."""
    reset_launches()
    qforest = core.quantize_forest(forest, X_calib, QUANT)
    pred = core.compile_forest(qforest, engine=engine, backend="cuda",
                               device=device)
    served, server = serve(pred, rows)
    counts = launch_counts()
    routes = tile_routes()
    launches = counts.pop(engine)
    if not np.array_equal(served, pred.predict(rows)):
        raise AssertionError("served output != synchronous predict")
    if not np.isfinite(served).all() or \
            served.shape != (len(rows), forest.n_classes):
        raise AssertionError(f"served output shape {served.shape} or "
                             "non-finite values")
    # on the card every batch is one launch; on the CPU (tests) none is
    if device.type == "cuda" and launches != server.stats.n_batches:
        raise AssertionError(f"{engine}: its kernel launched {launches} "
                             f"times for {server.stats.n_batches} batches")
    check_routes(routes, {engine: launches}, engine)
    if any(counts.values()):
        raise AssertionError(f"{engine}: other kernels launched {counts}")
    return pred, served, server, launches


def check_routes(routes: dict, launches: dict, what: str) -> None:
    """Every launch of the forest kernels (``routes``, by engine, read with
    ``launches``) staged its rows of x in shared memory: no dataset of the
    repo is wide enough for the global-memory route."""
    want = {k.engine: {"smem_x": launches.get(k.engine, 0), "global_x": 0}
            for k in KERNELS}
    if routes != want:
        raise AssertionError(f"{what}: x-tile routes {routes}, expected "
                             f"{want}")


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


class ExitRecorder:
    """A cascade predictor as ``ForestServer`` sees it, keeping each served
    batch's per-stage exit counts."""

    def __init__(self, pred):
        self.pred, self.batches = pred, []

    def predict(self, X):
        out = self.pred.predict(X)
        self.batches.append(self.pred.last_exit_counts.copy())
        return out

    @property
    def last_exit_counts(self):
        return self.pred.last_exit_counts


def stages_entered(counts) -> int:
    """How many stages a batch with these exit counts ran: those that some
    row reached."""
    reach = np.cumsum(np.asarray(counts)[::-1])[::-1]
    return int((reach > 0).sum())


def cascade_operands(forest, stages, policy, X, device, n_invalid=0):
    """``cascade_qs_forward``'s operands for ``forest``, a prepared
    ``policy`` and rows ``X``, the last ``n_invalid`` rows marked invalid:
    (x, valid, arrays, keyword arguments)."""
    fn = ops.cuda_fused_cascade_qs(forest, stages, policy, block_t=BLOCK_T,
                                   device=device)
    xq = core.quantize_inputs(forest, np.asarray(X)).astype(np.float32)
    x = torch.from_numpy(xq).to(device)
    valid = torch.arange(len(X), device=device) < len(X) - n_invalid
    kw = dict(stage_bounds=fn.stage_bounds, policy=policy,
              inv_scale=1.0 / core.leaf_scale(forest),
              out_dtype=fn.out_dtype)
    return x, valid, fn.arrays, kw


def compare_cascade(forest, stages, policy, X, device, atol: float,
                    n_invalid=0):
    """``cascade_qs_forward`` vs its plain version on the same operands,
    ``policy`` prepared anew for ``forest``, the last ``n_invalid`` rows
    invalid: the exit stages must be identical, the scores bit-exact on
    int-accum forests and within rtol / ``atol`` otherwise, invalid rows
    0 at the last stage, and a second launch must give the same bits.
    Returns (max |diff| of the scores, per-stage exit counts of the valid
    rows)."""
    policy = copy.copy(policy)
    policy.prepare(forest, stages)
    x, valid, arrays, kw = cascade_operands(forest, stages, policy, X,
                                            device, n_invalid)
    got, got_exit = cascade_qs_forward(x, valid, *arrays, **kw)
    want, want_exit = cascade_qs_forward_reference(x, valid, *arrays, **kw)
    again, again_exit = cascade_qs_forward(x, valid, *arrays, **kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    err = float((got.double() - want.double()).abs().max())
    tag = (forest.n_trees, forest.n_leaves, forest.n_features,
           forest.n_classes, len(X), stages, policy.tag(),
           "int16" if forest.int_accum else "float")
    flips = int((got_exit != want_exit).sum())
    if flips:
        raise AssertionError(f"cascade {tag}: {flips} rows exit at another "
                             "stage than in the plain version")
    if forest.int_accum:
        if not torch.equal(got, want):
            raise AssertionError(f"cascade {tag}: kernel != plain version "
                                 f"(max |diff| {err})")
    elif not torch.allclose(got, want, rtol=RTOL, atol=atol):
        raise AssertionError(f"cascade {tag}: max |diff| {err} > atol "
                             f"{atol}")
    if got[~valid].any() or (got_exit[~valid] != len(stages) - 1).any():
        raise AssertionError(f"cascade {tag}: an invalid row scored or "
                             "exited early")
    if not (torch.equal(got, again) and torch.equal(got_exit, again_exit)):
        raise AssertionError(f"cascade {tag}: two launches differ")
    counts = torch.bincount(got_exit[valid].long(), minlength=len(stages))
    return err, counts.cpu().numpy()


def cascade_path(forest, X_train, X_cal, y_cal, rows, y_rows, device,
                 stages=CASCADE_STAGES):
    """The cascade slice's main path: quantize → staged cascade →
    ``calibrate`` → serve fused and staged on ``backend="cuda"``.  Each
    served run starts with every launch count at 0 and must launch only
    its kernel: fused ``cascade_qs_forward`` once per batch (tier 2),
    staged ``qs_forward`` once per stage with survivors, and the tier-1
    fused cascade on ``engine="bitmm"`` / ``"gemm"`` its engine's kernel
    once per stage with survivors (none at all on the CPU).  All four must
    agree bit for bit, scores and per-batch exit counts, and equal
    synchronous ``predict``.  Then a disabled gate served fused must equal
    the plain bitvector engine, and ``ScoreBoundGate`` must keep every
    row's class."""
    on_card = device.type == "cuda"
    qforest = core.quantize_forest(forest, X_train, QUANT)
    staged = core.compile_forest(qforest, engine="bitvector", backend="cuda",
                                 device=device,
                                 cascade=CascadeSpec(stages))
    cal = calibrate(staged, X_cal, y_cal, floor_pp=CASCADE_FLOOR_PP)
    staged.set_policy(cal.policy)
    fused = {engine: core.compile_forest(
        qforest, engine=engine, backend="cuda", device=device,
        cascade=CascadeSpec(stages, cal.policy, fused=True))
        for engine in CASCADE_TIER1_ENGINES + ("bitvector",)}
    for engine in CASCADE_TIER1_ENGINES:
        if fused[engine].host_syncs != len(stages):
            raise AssertionError(f"tier-1 fused {engine}: host_syncs "
                                 f"{fused[engine].host_syncs}")
    runs = {}
    preds = [("fused", fused["bitvector"]), ("staged", staged)] + [
        (f"fused_{e}", fused[e]) for e in CASCADE_TIER1_ENGINES]
    for name, pred in preds:
        reset_launches()
        rec = ExitRecorder(pred)
        served, server = serve(rec, rows)
        counts = launch_counts()
        routes = tile_routes()
        cascade_routes = dict(cascade_qs_forward.launches_by_route)
        if not np.array_equal(served, pred.predict(rows)):
            raise AssertionError(f"{name} cascade: served != predict")
        if not np.isfinite(served).all() or \
                served.shape != (len(rows), forest.n_classes):
            raise AssertionError(f"{name} cascade: served shape "
                                 f"{served.shape} or non-finite values")
        entered = sum(stages_entered(c) for c in rec.batches)
        want = {"cascade": server.stats.n_batches} if name == "fused" \
            else {"bitvector": entered} if name == "staged" \
            else {name[len("fused_"):]: entered}
        want = {k: want.get(k, 0) if on_card else 0 for k in counts}
        if counts != want:
            raise AssertionError(f"{name} cascade: kernel launches {counts},"
                                 f" expected {want}")
        check_routes(routes, counts, f"{name} cascade")
        if cascade_routes != {"smem_x": counts["cascade"], "global_x": 0}:
            raise AssertionError(
                f"{name} cascade: cascade_qs_forward routes "
                f"{cascade_routes}, expected {counts['cascade']} smem_x")
        if sum(server.stats.stage_exit_counts) != len(rows):
            raise AssertionError(f"{name} cascade: exit counts "
                                 f"{server.stats.stage_exit_counts} for "
                                 f"{len(rows)} rows")
        runs[name] = dict(served=served, batches=rec.batches, server=server,
                          launches=counts, routes=cascade_routes)
    f = runs["fused"]
    for name, other in runs.items():
        if not np.array_equal(f["served"], other["served"]):
            raise AssertionError(f"fused (tier 2) and {name} cascades serve "
                                 "different scores")
        if len(f["batches"]) != len(other["batches"]) or not all(
                np.array_equal(a, b) for a, b in zip(f["batches"],
                                                     other["batches"])):
            raise AssertionError(f"fused (tier 2) and {name} cascades exit "
                                 "rows at different stages")
    st = runs["staged"]
    fused = fused["bitvector"]
    plain = core.compile_forest(qforest, engine="bitvector", backend="cuda",
                                device=device)
    full = plain.predict(rows)
    policy = fused.policy
    fused.set_policy(MarginGate(np.inf))
    never, _ = serve(fused, rows)
    if not np.array_equal(never, full):
        raise AssertionError("fused cascade with a disabled gate != the "
                             "bitvector engine on the whole forest")
    fused.set_policy(ScoreBoundGate())
    if not np.array_equal(fused.predict_class(rows), full.argmax(axis=1)):
        raise AssertionError("ScoreBoundGate changed a row's class")
    fused.set_policy(policy)
    exits = np.asarray(f["server"].stats.stage_exit_counts)
    acc_gated = float((f["served"].argmax(axis=1) == y_rows).mean())
    acc_full = float((full.argmax(axis=1) == y_rows).mean())
    # the reference's held-out sanity bound (tests/test_cascade.py:451)
    if acc_gated < acc_full - 0.02:
        raise AssertionError(f"gated accuracy {acc_gated:.4f} more than 2 pp"
                             f" below the full forest's {acc_full:.4f}")
    return dict(
        qforest=qforest, policy=fused.policy, calibration=cal, fused=fused,
        stages=fused.stages, launches=f["launches"]["cascade"],
        routes=f["routes"],
        staged_launches=st["launches"]["bitvector"],
        tier1_launches={e: runs[f"fused_{e}"]["launches"][e]
                        for e in CASCADE_TIER1_ENGINES},
        n_batches=f["server"].stats.n_batches,
        mean_batch=f["server"].stats.batch_sizes.mean(),
        exit_fractions=f["server"].stats.summary()["exit_fractions"],
        mean_trees=float((exits * np.asarray(fused.stages)).sum()
                         / exits.sum()),
        acc_gated=acc_gated, acc_full=acc_full,
        compute_p50_ms={name: r["server"].stats.summary()["compute_p50_ms"]
                        for name, r in runs.items()})


def cascade_bound(x, valid, arrays, kw, exit_stage, stages):
    """Least time for the cascade on these operands and this batch's
    exits: bytes as ``bound`` counts them (plus ``valid``, the stage
    offsets and the exit stages); operations as ``Kernel.work`` counts
    the bitvector kernel's, for the rows that reach each stage times that
    stage's trees."""
    B = x.shape[0]
    N, W = arrays[0].shape[1], arrays[2].shape[-1]
    C = arrays[-1].shape[-1]
    ex = exit_stage[valid].cpu().numpy()
    trees = np.diff((0,) + tuple(stages))
    reach = [int((ex >= k).sum()) for k in range(len(stages))]
    n_ops = sum(r * int(t) for r, t in zip(reach, trees)) \
        * (N * (1 + W) + C)
    nbytes = sum(t.numel() * t.element_size() for t in (x, valid) + arrays) \
        + 4 * len(kw["stage_bounds"]) + B * C * 4 + B * 4
    t_ops, t_bytes = n_ops / ALU_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes, n_ops, reach


def exited_pair_share(valid, exit_stage, stage_bounds) -> float:
    """The share of the (row, tree) pairs ``cascade_qs_forward`` walks
    that belong to rows already exited: a 32-row tile walks a stage's
    (padded) trees for all its rows while any of them is still active."""
    ex = np.where(valid.cpu().numpy(), exit_stage.cpu().numpy(), -1)
    ex = np.pad(ex, (0, -len(ex) % TILE_ROWS), constant_values=-1)
    tiles = ex.reshape(-1, TILE_ROWS)
    trees = np.diff(stage_bounds)
    walked = needed = 0
    for k, t in enumerate(trees):
        live = (tiles >= k).any(axis=1)
        walked += int(live.sum()) * TILE_ROWS * int(t)
        needed += int((tiles >= k).sum()) * int(t)
    return 1.0 - needed / walked if walked else 0.0


def host_split(pred, X, device, reps: int = 20) -> dict:
    """Host milliseconds (median of ``reps``) of each part of one served
    fused batch: ``FusedCascadePredictor.predict`` on the kernel tier
    done step by step, with a synchronize after each step that reaches
    the card.  The result must equal ``pred.predict(X)``."""
    fn = ops.cuda_fused_cascade_qs(pred.forest, pred.stages, pred.policy,
                                   device=device, **pred.engine_kw)
    K = len(pred.stages)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    times = {k: [] for k in ("quantize", "pad", "h2d", "kernel",
                             "exit_counts", "d2h")}
    for _ in range(reps):
        t = [time.perf_counter()]
        feed = ensure_feature_column(np.asarray(pred.transform_inputs(X)))
        feed = feed.astype(np.float32)
        t.append(time.perf_counter())
        n, mult = feed.shape[0], pred._row_mult
        bucket = mult * bucket_batch(-(-n // mult))
        Xp = np.zeros((bucket,) + feed.shape[1:], dtype=feed.dtype)
        Xp[:n] = feed
        t.append(time.perf_counter())
        xt = as_input_tensor(Xp, device)
        sync()
        t.append(time.perf_counter())
        valid = torch.arange(bucket, device=device) < n
        scores, exit_stage = fn(xt, valid)
        sync()
        t.append(time.perf_counter())
        stages = torch.arange(K, dtype=torch.int32, device=device)
        hot = (exit_stage[:, None] == stages[None, :]) & valid[:, None]
        counts = hot.sum(dim=0).cpu().numpy()
        t.append(time.perf_counter())
        out = scores[:n].cpu().numpy()
        t.append(time.perf_counter())
        for key, a, b in zip(times, t, t[1:]):
            times[key].append((b - a) * 1e3)
    if not np.array_equal(out, pred.predict(X)) or \
            not np.array_equal(counts, pred.last_exit_counts):
        raise AssertionError("host split: the steps disagree with predict")
    return {k: float(np.median(v)) for k, v in times.items()} | {
        "bucket": bucket}


def pass_times(path, device, X_calib, **plan_kw):
    """Host milliseconds of each compile pass for the model file ``path``:
    ``core.pipeline``'s passes run one by one as ``compile_plan`` runs
    them, with a synchronize after each.  Returns (ms by pass, predictor).
    """
    plan = pipeline.CompilePlan(device=device, **plan_kw)
    ctx = {"X_calib": X_calib, "n_features": None, "n_classes": 1,
           "load_kw": None, "opt_cache": None}
    obj, ms = path, {}
    for name in pipeline.PIPELINE:
        t0 = time.perf_counter()
        obj = pipeline.PASSES[name](obj, plan, ctx)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
    return ms, obj


def opt_pass_times(forest, X_calib, level=SERVED_OPT) -> dict:
    """Host milliseconds of each optimizer pass of ``level`` and of the
    oracle-equivalence check, run one by one on ``forest`` as
    ``optim.optimize`` runs them."""
    names, _ = optim.resolve_opt(level)
    ms, out = {}, forest
    for name in names:
        t0 = time.perf_counter()
        out = optim.OPT_PASSES[name].fn(out, {"X_calib": X_calib})
        ms[name] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    optim.verify_equivalence(forest, out)
    ms["verify"] = (time.perf_counter() - t0) * 1e3
    return ms


def opt_summary(before, after) -> str:
    """Nodes, leaves L, trees, features and unique thresholds of two IRs."""
    b, a = optim.ForestStats.of(before), optim.ForestStats.of(after)
    return (f"nodes {b.n_nodes}→{a.n_nodes}, L {b.n_leaves}→{a.n_leaves}, "
            f"trees {b.n_trees}→{a.n_trees}, features {b.n_features}→"
            f"{a.n_features}, unique thresholds {b.n_unique_splits}→"
            f"{a.n_unique_splits}, depth {b.max_depth}→{a.max_depth}")


def packed_path(qforest, X_calib, rows, device, tmpdir,
                engines=tuple(k.engine for k in KERNELS)) -> dict:
    """The compile slice's first path: ``qforest`` written with
    ``io.save_forest``, compiled from the file at ``SERVED_OPT`` for each
    engine on ``backend="cuda"`` and served through ``ForestServer``.
    Every launch count is set to 0 just before each engine's compile and
    read just after its serve: its kernel once per batch (none on the
    CPU), on the x-tile route, no other kernel.  The served scores must
    equal, bit for bit, the in-memory -O0 compile on the same device and
    the plain torch engine compiled from the file at ``SERVED_OPT``, and
    each other."""
    path = os.path.join(tmpdir, "msn.repro.npz")
    io.save_forest(qforest, path)
    on_card = device.type == "cuda"
    out = {}
    for engine in engines:
        reset_launches()
        pred = core.compile_plan(path, engine=engine, backend="cuda",
                                 opt=SERVED_OPT, X_calib=X_calib,
                                 device=device)
        served, server = serve(pred, rows)
        counts = launch_counts()
        routes = tile_routes()
        launches = counts.pop(engine)
        if on_card and launches != server.stats.n_batches:
            raise AssertionError(f"{engine} from {path}: {launches} "
                                 f"launches for {server.stats.n_batches} "
                                 "batches")
        if any(counts.values()):
            raise AssertionError(f"{engine} from {path}: other kernels "
                                 f"launched {counts}")
        check_routes(routes, {engine: launches}, f"{engine} from {path}")
        o0 = core.compile_forest(qforest, engine=engine, backend="cuda",
                                 device=device).predict(rows)
        plain = core.compile_plan(path, engine=engine, backend="torch",
                                  opt=SERVED_OPT, X_calib=X_calib,
                                  device=device).predict(rows)
        if not (np.array_equal(served, o0) and np.array_equal(served, plain)):
            raise AssertionError(
                f"{engine} {SERVED_OPT} from {path}: served scores differ "
                f"from -O0 in memory ({np.abs(served - o0).max()}) or from "
                f"plain torch {SERVED_OPT} ({np.abs(served - plain).max()})")
        out[engine] = dict(pred=pred, served=served, launches=launches,
                           n_batches=server.stats.n_batches)
    for engine, r in out.items():
        if not np.array_equal(r["served"], out[engines[0]]["served"]):
            raise AssertionError(f"{engine} {SERVED_OPT} serves other scores"
                                 f" than {engines[0]}")
    return out


def shim_json(rf, n_features: int) -> dict:
    """A trained ``RandomForest``'s CART trees as the sklearn-shim JSON of
    ``tests/fixtures/sklearn_rf_classifier.json``: per tree, preorder node
    arrays (leaves: children -1, feature -2, threshold -2.0) and each
    node's class values (a leaf's class distribution; zeros inside)."""
    C = rf.n_classes
    estimators = []
    for tree in rf.trees:
        arr = {k: [] for k in ("children_left", "children_right", "feature",
                               "threshold", "value")}

        def walk(nd) -> int:
            i = len(arr["feature"])
            arr["children_left"].append(-1)
            arr["children_right"].append(-1)
            if nd.is_leaf:
                arr["feature"].append(-2)
                arr["threshold"].append(-2.0)
                arr["value"].append([[float(v) for v in nd.value]])
                return i
            arr["feature"].append(int(nd.feature))
            arr["threshold"].append(float(nd.threshold))
            arr["value"].append([[0.0] * C])
            arr["children_left"][i] = walk(nd.left)
            arr["children_right"][i] = walk(nd.right)
            return i

        walk(tree.root)
        estimators.append(arr)
    return {"n_features": n_features, "n_classes": C,
            "estimators": estimators}


def model_file_cascade(rf, n_features, X_train, X_cal, y_cal, rows, y_rows,
                       device, tmpdir, stages=CASCADE_STAGES) -> dict:
    """The compile slice's cascade: ``rf`` written as sklearn-shim JSON,
    compiled from the file (int16 int-accum, ``SERVED_OPT``) into a staged
    cascade in plain torch, whose gate ``calibrate`` fits, and into the
    fused kernel cascade with that gate, served through ``ForestServer``.
    Launch counts are set to 0 just before the fused compile and read just
    after its serve: ``cascade_qs_forward`` once per batch, no other kernel
    (none on the CPU).  Scores and per-batch exit counts must equal the
    staged ``SERVED_OPT`` cascade's bit for bit, and the full
    ``SERVED_OPT`` forest must equal -O0 on the same rows."""
    path = os.path.join(tmpdir, "mnist_rf.json")
    with open(path, "w") as f:
        json.dump(shim_json(rf, n_features), f)
    kw = dict(engine="bitvector", quant=QUANT, X_calib=X_train,
              device=device)
    staged = core.compile_plan(path, backend="torch", opt=SERVED_OPT,
                               cascade=CascadeSpec(stages), **kw)
    cal = calibrate(staged, X_cal, y_cal, floor_pp=CASCADE_FLOOR_PP)
    staged.set_policy(cal.policy)
    reset_launches()
    fused = core.compile_plan(path, backend="cuda", opt=SERVED_OPT,
                              cascade=CascadeSpec(stages, cal.policy,
                                                  fused=True), **kw)
    rec = ExitRecorder(fused)
    served, server = serve(rec, rows)
    counts = launch_counts()
    routes = dict(cascade_qs_forward.launches_by_route)
    want = {k: 0 for k in counts}
    if device.type == "cuda":
        want["cascade"] = server.stats.n_batches
    if counts != want or routes != {"smem_x": want["cascade"],
                                    "global_x": 0}:
        raise AssertionError(f"cascade from {path}: launches {counts} "
                             f"(routes {routes}), expected {want}")
    srec = ExitRecorder(staged)
    staged_served, _ = serve(srec, rows)
    if not np.array_equal(served, staged_served) or not all(
            np.array_equal(a, b) for a, b in zip(rec.batches,
                                                 srec.batches)):
        raise AssertionError(f"fused {SERVED_OPT} cascade from {path} != "
                             f"the staged {SERVED_OPT} cascade in plain torch")
    full = {lvl: core.compile_plan(path, backend="cuda", opt=lvl,
                                   **kw).predict(rows)
            for lvl in (SERVED_OPT, "O0")}
    if not np.array_equal(full[SERVED_OPT], full["O0"]):
        raise AssertionError(f"the full {SERVED_OPT} forest from {path} != "
                             "-O0")
    exits = np.asarray(server.stats.stage_exit_counts)
    return dict(path=path, fused=fused, policy=cal.policy,
                launches=counts["cascade"], n_batches=server.stats.n_batches,
                imported=io.load_model(path), mean_trees=float(
                    (exits * np.asarray(fused.stages)).sum() / exits.sum()),
                acc=float((served.argmax(axis=1) == y_rows).mean()),
                acc_full=float((full["O0"].argmax(axis=1) == y_rows).mean()))


def fixture_path(device) -> list:
    """Each golden model file of ``tests/fixtures`` compiled with
    ``backend="cuda"`` on every kernel engine: one launch per predict (on
    the card) and the expected predictions within the reference test's
    tolerance.  Returns (fixture, engine, max |diff|) rows."""
    with open(os.path.join(FIXTURES, "expected.json")) as f:
        expected = json.load(f)
    out = []
    for name, exp in sorted(expected.items()):
        X, want = np.asarray(exp["X"]), np.asarray(exp["predict"])
        for k in KERNELS:
            pred = core.compile_plan(os.path.join(FIXTURES, name + ".json"),
                                     engine=k.engine, backend="cuda",
                                     device=device, load_kw=exp["kw"])
            before = k.launch.launches
            got = pred.predict(X)
            if device.type == "cuda" and k.launch.launches != before + 1:
                raise AssertionError(f"fixture {name}: {k.source_name} did "
                                     "not launch")
            np.testing.assert_allclose(got, want, rtol=FIXTURE_RTOL,
                                       atol=FIXTURE_ATOL,
                                       err_msg=f"fixture {name}/{k.engine}")
            out.append((name, k.engine, float(np.abs(got - want).max())))
    return out


def save_load_path(qforest, rows, device, tmpdir) -> dict:
    """``ForestServer.save`` / ``load`` of torch-engine predictors of
    ``qforest``: loaded with ``device=None`` (the card; the CPU rehearsal
    names its device), bit-identical predictions, and the host ms from
    compile (or load) to the first predicted batch, each after an
    untimed compile and predict warmed the same operations.  Saving a
    ``cuda`` predictor must raise ``ValueError``."""
    load_device = None if device.type == "cuda" else device
    batch = rows[:MAX_BATCH]
    out = {}
    for engine in SAVED_ENGINES:
        core.compile_forest(qforest, engine=engine, backend="torch",
                            device=device).predict(batch)
        t0 = time.perf_counter()
        pred = core.compile_forest(qforest, engine=engine, backend="torch",
                                   device=device)
        first = pred.predict(batch)
        compile_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(tmpdir, f"{engine}.srv.npz")
        ForestServer(pred, max_batch=MAX_BATCH).save(path)
        t0 = time.perf_counter()
        server = ForestServer.load(path, device=load_device)
        loaded_first = server.predictor.predict(batch)
        load_ms = (time.perf_counter() - t0) * 1e3
        if server.predictor.device.type != device.type or \
                server.batcher.max_batch != MAX_BATCH:
            raise AssertionError(f"{engine}: loaded on "
                                 f"{server.predictor.device}, max_batch "
                                 f"{server.batcher.max_batch}")
        if not (np.array_equal(first, loaded_first) and np.array_equal(
                pred.predict(rows), server.predictor.predict(rows))):
            raise AssertionError(f"{engine}: the loaded server predicts "
                                 "other scores")
        out[engine] = dict(compile_ms=compile_ms, load_ms=load_ms,
                           bytes=os.path.getsize(path))
    cuda_pred = core.compile_forest(qforest, engine="bitvector",
                                    backend="cuda", device=device)
    path = os.path.join(tmpdir, "cuda.srv.npz")
    try:
        ForestServer(cuda_pred).save(path)
    except ValueError as e:
        out["cuda_error"] = str(e)
    else:
        raise AssertionError("saving a cuda predictor did not raise")
    if os.path.exists(path):
        raise AssertionError("a refused save left a file behind")
    return out


def flash_inputs(B, Sq, Sk, H, K, hd, dtype, device, seed=0):
    """Seeded head-major q (B*H, Sq, hd) and k/v (B*K, Sk, hd), made on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b * h, n, hd, generator=g, device=device)
                 .to(dtype) for b, h, n in ((B, H, Sq), (B, K, Sk),
                                            (B, K, Sk)))


def compare_flash(B, Sq, Sk, H, K, hd, causal, dtype, device) -> float:
    """``flash_forward`` vs its plain version on the same inputs, within
    the reference's tolerance for ``dtype``; on the card two launches must
    give the same bits.  Returns the largest absolute difference."""
    q, k, v = flash_inputs(B, Sq, Sk, H, K, hd, dtype, device,
                           seed=Sq * 31 + Sk + hd)
    got = flash_forward(q, k, v, causal=causal, n_rep=H // K)
    want = flash_forward_reference(q, k, v, causal=causal, n_rep=H // K)
    again = flash_forward(q, k, v, causal=causal, n_rep=H // K)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tol = FLASH_TOL_F32 if dtype == torch.float32 else FLASH_TOL_BF16
    err = float((got.float() - want.float()).abs().max())
    tag = (B, Sq, Sk, H, K, hd, causal, str(dtype))
    if got.dtype != dtype or got.shape != q.shape:
        raise AssertionError(f"flash {tag}: out {got.dtype} {got.shape}")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"flash {tag}: kernel vs plain version max "
                             f"|diff| {err} > {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"flash {tag}: two launches differ")
    return err


def visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(q, k) pairs the mask leaves visible in one head: all, or for the
    top-left causal mask min(q + 1, Sk) keys for query q."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + max(Sq - Sk, 0) * Sk


def flash_bound(q, k, v, causal: bool):
    """Least time for the attention on these operands: 4*hd operations per
    visible (q, k) pair (q.k and p*v; the softmax's exps not counted) at
    the bf16 tensor rate, or q, k, v read and out written once at the HBM
    rate — the larger."""
    BH, Sq, hd = q.shape
    n_ops = 4 * hd * BH * visible_pairs(Sq, k.shape[1], causal)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    t_ops, t_bytes = n_ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes, n_ops


def library_attention(q4, k4, v4):
    """One ``scaled_dot_product_attention`` call computing
    ``flash_forward``'s function (causal, GQA) on the same inputs, on
    PyTorch's fused backends only (the math backend would hold the whole
    score matrix: 64 GB at S = 32768).  With ``enable_gqa`` where a fused
    backend takes it, else over k/v repeated to every query head.
    Returns (call, which form).  A yardstick: the port never calls it."""
    def gqa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              enable_gqa=True)
    with sdpa_kernel(FUSED_SDPA):
        try:
            gqa()
            return gqa, "enable_gqa"
        except RuntimeError:
            pass
    rep = q4.shape[1] // k4.shape[1]
    k_r, v_r = (t.repeat_interleave(rep, dim=1) for t in (k4, v4))
    return (lambda: F.scaled_dot_product_attention(q4, k_r, v_r,
                                                   is_causal=True),
            "k/v repeated")


def lm_prompts(cfg, batch: int, seq_len: int) -> np.ndarray:
    """Seeded prompts from the reference's synthetic token pipeline."""
    return SyntheticTokens(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq_len, global_batch=batch,
        seed=LM_SEED)).batch(0)


def rel_logit_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max())


def lm_path(cfg, prompts: np.ndarray, n_new: int, device) -> dict:
    """The LM slice's main path and its checks.  Seeded f32 weights on
    ``device``; the served model computes in bf16 on ``backend="cuda"``.
    Every launch count is set to 0 just before the served ``generate``
    and read just after: ``flash_forward`` must have launched once per
    attention layer (none on the CPU) and no other kernel at all.  Then,
    at the same weights: f32 ``cuda`` and ``torch`` must give the same
    greedy tokens and prefill logits within ``LM_LOGIT_TOL_F32`` of the
    largest; bf16 ``cuda`` and ``torch`` prefill logits within
    ``LM_LOGIT_TOL_BF16``; and teacher-forced f32 ``decode_step`` over the
    first ``LM_TEACHER_STEPS`` positions must match ``Model.forward``."""
    B, S = prompts.shape
    max_len = S + n_new + 1
    n_attn = cfg.n_layers                       # dense: every layer
    models = {(dt, b): Model(cfg, dt, backend=b, device=device)
              for dt in (torch.bfloat16, torch.float32)
              for b in ("cuda", "torch")}
    params = models[torch.float32, "cuda"].init_params(LM_SEED)
    servers = {key: LMServer(m, params, batch=B, max_len=max_len)
               for key, m in models.items()}
    served = servers[torch.bfloat16, "cuda"]

    reset_launches()
    out = served.generate(prompts, n_new)
    counts = launch_counts()
    launches = counts.pop("flash")
    routes = dict(flash_forward.launches_by_route)
    want = n_attn if device.type == "cuda" else 0
    if launches != want or any(counts.values()) or \
            routes != {"wgmma": want, "simt": 0}:
        raise AssertionError(f"LM generate: flash_forward launched "
                             f"{launches} times ({routes}) for {n_attn} "
                             f"attention layers; other kernels {counts}")
    if out.shape != (B, S + n_new) or out.dtype != np.int32 or \
            not np.array_equal(out[:, :S], prompts) or \
            out.min() < 0 or out.max() >= cfg.vocab:
        raise AssertionError(f"LM generate: output {out.shape} {out.dtype}"
                             f" out of range or prompt changed")
    times_cold = dict(served.last_times)
    before = flash_forward.launches
    if not np.array_equal(served.generate(prompts, n_new), out):
        raise AssertionError("LM generate: a second call differs")
    if flash_forward.launches - before != want:
        raise AssertionError("LM generate: second call's launches")
    times = dict(served.last_times)

    tokens32 = {b: servers[torch.float32, b].generate(prompts, n_new)
                for b in ("cuda", "torch")}
    if not np.array_equal(tokens32["cuda"], tokens32["torch"]):
        diff = np.argwhere(tokens32["cuda"] != tokens32["torch"])[0]
        raise AssertionError(f"f32 greedy tokens differ between cuda and "
                             f"torch first at (row, pos) {tuple(diff)}")
    logits = {}
    for key, server in servers.items():
        state = server.model.init_decode_state(B, max_len)
        _, logits[key] = server._prefill(state, prompts)
        if not torch.isfinite(logits[key]).all() or \
                logits[key].shape != (B, cfg.vocab):
            raise AssertionError(f"prefill logits {key}: shape "
                                 f"{tuple(logits[key].shape)} or not finite")
    err32 = rel_logit_err(logits[torch.float32, "cuda"],
                          logits[torch.float32, "torch"])
    err16 = rel_logit_err(logits[torch.bfloat16, "cuda"],
                          logits[torch.bfloat16, "torch"])
    err16_vs32 = rel_logit_err(logits[torch.bfloat16, "cuda"],
                               logits[torch.float32, "torch"])
    if err32 > LM_LOGIT_TOL_F32 or err16 > LM_LOGIT_TOL_BF16:
        raise AssertionError(f"prefill logits cuda vs torch: f32 {err32} "
                             f"(tol {LM_LOGIT_TOL_F32}), bf16 {err16} (tol "
                             f"{LM_LOGIT_TOL_BF16}) of the largest |logit|")

    m32 = models[torch.float32, "cuda"]
    steps = min(LM_TEACHER_STEPS, S)
    full = m32.forward(params, prompts[:, :steps])
    state = m32.init_decode_state(B, steps + 1, dtype=torch.float32)
    got = []
    for i in range(steps):
        lg, state = m32.decode_step(params, state, prompts[:, i:i + 1])
        got.append(lg)
    dec_err = float((torch.stack(got, dim=1) - full).abs().max())
    if not torch.allclose(torch.stack(got, dim=1), full, rtol=LM_DECODE_TOL,
                          atol=LM_DECODE_TOL):
        raise AssertionError(f"teacher-forced decode vs forward: max |diff|"
                             f" {dec_err} > {LM_DECODE_TOL}")
    return dict(tokens=out, launches=launches, routes=routes, times=times,
                times_cold=times_cold, err32=err32, err16=err16,
                err16_vs32=err16_vs32, dec_err=dec_err, steps=steps)


def demangle(names) -> dict:
    """Mangled kernel name → ``name<template arguments>`` (e.g.
    ``flash_wgmma_kernel<64,1>``), demangled by the toolkit's
    ``cu++filt``, then cut to the name and its template arguments."""
    names = sorted(set(names))
    if not names:
        return {}
    text = subprocess.run([build.toolkit_binary("cu++filt"), *names],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.splitlines()
    out = {}
    for mangled, full in zip(names, text):
        full = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", full)
        depth, end = 0, len(full)
        for i, ch in enumerate(full):       # the parameter list's "("
            depth += (ch == "<") - (ch == ">")
            if ch == "(" and depth == 0:
                end = i
                break
        name = full[:end]
        ret, _, rest = name.partition(" ")
        if rest and "<" not in ret:         # "void name<...>"
            name = rest
        out[mangled] = re.sub(r"\((?:unsigned )?(?:int|bool)\)|\s", "",
                              name)
    return out


def ptxas_functions(log: str):
    """(kernel, registers, static shared bytes, spill-store bytes) per
    entry function in an ``nvcc -Xptxas -v`` log."""
    names = demangle(re.findall(r"Compiling entry function '([^']+)'",
                                log))
    out, name, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = names[m.group(1)], 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), int(sm.group(1)) if sm else 0,
                        spill))
            name = None
    return out


def opcode_counts(sass: str, opcode: str) -> dict:
    """Instructions of ``opcode`` (``HGMMA``: wgmma; ``IMMA``: integer
    mma.sync) per kernel in ``cuobjdump -sass`` output."""
    names = demangle(re.findall(r"Function : (\S+)", sass))
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = names[m.group(1)]
            counts[name] = 0
        elif name and opcode in line:
            counts[name] += 1
    return counts


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


def graph_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the device: ``reps`` calls captured in
    one CUDA graph and replayed, by CUDA events, after two eager warm-up
    calls.  Replay leaves out the host's work per call (the wrapper's
    checks, the ctypes call), which ``cuda_ms`` counts wherever it exceeds
    the kernel's own time."""
    fn(), fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(kernel, x, arrays, kw):
    """Least time for the kernel's function on these operands: each input
    read and the output written once at the HBM rate, or its operations
    (``Kernel.work``) at their peak rates — the larger."""
    B, C = x.shape[0], arrays[-1].shape[-1]
    nbytes = sum(t.numel() * t.element_size() for t in (x,) + arrays) \
        + B * C * torch.tensor([], dtype=kw["out_dtype"]).element_size()
    n_ops, t_ops = kernel.work(x, arrays)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes, n_ops


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = card_line()

    # 1. software and card
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
          f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
          f"  count {torch.cuda.device_count()}")
    print(f"card: {card}")

    # 2. build from the repo's sources
    t0 = time.perf_counter()
    sources = [k.source_name for k in KERNELS] + ["cascade_qs_forward",
                                                  "flash_forward"]
    paths = build.build(sources)
    print(f"built {', '.join(str(p) for p in paths.values())} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in sources:
        fns = ptxas_functions(build.build_log(name))
        print(f"ptxas {name}: {len(fns)} functions, at most "
              f"{max((r for _, r, _, _ in fns), default=0)} registers, "
              f"{sum(sp > 0 for *_, sp in fns)} with spill stores (at most "
              f"{max((sp for *_, sp in fns), default=0)} bytes)")
    # per function: flash_forward's kernels, and the forest kernels' at
    # W <= 2 / two k-steps (the MSN and mnist forests: L = 64, N = 63)
    for name, keep in (
            ("flash_forward", lambda fn: True),
            ("qs_forward", lambda fn: "qs_tile_kernel<2," in fn),
            ("qs_bitmm_forward", lambda fn: "bitmm_tile_kernel<2," in fn),
            ("gemm_forward", lambda fn: "gemm_tile_kernel<2," in fn),
            ("cascade_qs_forward", lambda fn: "cascade_kernel<2,16," in fn)):
        for fn, regs, smem, spill in ptxas_functions(build.build_log(name)):
            if keep(fn):
                print(f"ptxas {name} {fn}: {regs} registers, {smem} bytes "
                      f"static shared memory, {spill} bytes spill stores")
    # the mnist cascade's instance (W = 2, C = 10 in CMAX 16, x tile,
    # int32) must not spill
    mnist_fns = [(fn, spill) for fn, _, _, spill in ptxas_functions(
        build.build_log("cascade_qs_forward"))
        if re.fullmatch(r"cascade_kernel<2,16,(1|true),int>", fn)]
    if len(mnist_fns) != 1 or mnist_fns[0][1]:
        raise AssertionError(f"cascade_qs_forward's mnist instance: "
                             f"{mnist_fns} (expected one, no spills)")
    for name in ("qs_bitmm_forward", "gemm_forward"):
        imma = opcode_counts(build.sass(name), "IMMA")
        tiles = {fn: n for fn, n in imma.items() if "_tile_kernel" in fn}
        print(f"SASS {name} (cuobjdump -sass): IMMA instructions in "
              f"{len(tiles)} tile kernels, {min(tiles.values(), default=0)}"
              f"-{max(tiles.values(), default=0)} each; at two k-steps "
              f"{ {fn: n for fn, n in tiles.items() if '<2,' in fn} }")
        if not tiles or min(tiles.values()) == 0:
            raise AssertionError(f"{name}'s tile kernels hold no IMMA: "
                                 f"{imma}")
    hgmma = opcode_counts(build.sass("flash_forward"), "HGMMA")
    wgmma_fns = {fn: n for fn, n in hgmma.items()
                 if "flash_wgmma_kernel" in fn}
    print(f"SASS flash_forward (cuobjdump -sass): HGMMA instructions "
          f"{wgmma_fns}; in the CUDA-core kernels "
          f"{sum(n for fn, n in hgmma.items() if fn not in wgmma_fns)}")
    if not wgmma_fns or min(wgmma_fns.values()) == 0:
        raise AssertionError(f"flash_forward's wgmma kernels hold no HGMMA: "
                             f"{hgmma}")

    # 3. each kernel vs its plain version vs the oracle
    msn = datasets.make_msn()
    T, L, d, C, B = FULL
    full = core.random_forest_ir(T, L, d, n_classes=C, seed=0)
    qfull = core.quantize_forest(full, msn.X_train, QUANT)
    rows_full = msn.X_test[:B]
    sweep = [(T_, L_, d_, C_, B_, T_ % 2 == 0, T_)
             for T_, L_, d_, C_, B_ in SHAPE_SWEEP]
    full_err = {}
    for k in KERNELS:
        shapes = sweep + ([(T_, L_, d_, C_, 24, f, s_)
                           for T_, L_, d_, C_, f, s_ in FOREST_SWEEP]
                          if k.engine == "bitmm" else [])
        worst = 0.0
        for T_, L_, d_, C_, B_, full_, seed in shapes:
            forest = core.random_forest_ir(T_, L_, d_, n_classes=C_,
                                           seed=seed, full=full_)
            X = np.random.default_rng(B_).normal(0, 1.3, size=(B_, d_))
            worst = max(worst, compare_kernel(k, forest, X, device, ATOL))
            compare_kernel(k, core.quantize_forest(forest, X, QUANT), X,
                           device, ATOL)
        err_float = compare_kernel(k, full, rows_full, device, ATOL_FULL)
        err_quant = compare_kernel(k, qfull, rows_full, device, ATOL_FULL)
        full_err[k.engine] = max(err_float, err_quant)
        print(f"{k.source_name}: {len(shapes)} sweep shapes, float max|diff| "
              f"{worst:.3g} (rtol {RTOL}, atol {ATOL}), int16 bit-exact; "
              f"full width T={T} L={L} d={d} C={C} B={B}: float max|diff| "
              f"{err_float:.3g} (atol {ATOL_FULL}), int16 bit-exact "
              f"({err_quant})")

    # 4. the main path at full width through each engine, then a trained
    # model's accuracy
    rows = np.concatenate([msn.X_test, msn.X_train])[:N_REQUESTS]
    launches, served = {}, {}
    for k in KERNELS:
        t0 = time.perf_counter()
        pred, served[k.engine], server, launches[k.engine] = main_path(
            full, msn.X_train, rows, device, engine=k.engine)
        wall = time.perf_counter() - t0
        stats = server.stats.summary()
        print(f"main path: {pred.plan.describe()}")
        print(f"{k.engine}: served {stats['n_requests']} requests in "
              f"{stats['n_batches']} batches (mean {stats['mean_batch']:.1f} "
              f"rows), {k.source_name} launches {launches[k.engine]}; served "
              f"== predict; {wall:.2f} s host wall incl. quantize+compile")
        print(f"{k.engine} per batch, host clock: predict (quantize rows, "
              f"pad, copy in, kernel, copy out) p50 "
              f"{stats['compute_p50_ms']:.3f} ms, max "
              f"{max(server.stats.compute_ms):.3f} ms [{card}]")
    for engine, out in served.items():
        if not np.array_equal(out, served["bitvector"]):
            raise AssertionError(f"{engine} served output differs from "
                                 "bitvector's on the same int16 forest")
    print(f"served int16 outputs bit-identical across {', '.join(served)}")
    acc_float, acc_quant, n_test = magic_accuracy(device)
    print(f"magic RF 128x64: float accuracy {acc_float:.4f}, int16 served "
          f"{acc_quant:.4f} on {n_test} rows (margin "
          f"{ACCURACY_MARGIN_PP} pp)")

    # 5. the cascade slice: the kernel against its plain version, then the
    # trained mnist cascade served fused and staged
    worst_cascade = 0.0
    for T_, L_, d_, C_, B_, st, gate, votes in CASCADE_SWEEP:
        forest = core.random_forest_ir(T_, L_, d_, n_classes=C_,
                                       seed=T_ + L_, full=False)
        if votes:
            forest = dataclasses.replace(
                forest, leaf_value=np.abs(forest.leaf_value))
        X = np.random.default_rng(B_).normal(0, 1.3, size=(B_, d_))
        # up to 512 f32 leaves summed in two orders (ATOL_FULL above)
        atol = ATOL if T_ <= 64 else ATOL_FULL
        err, _ = compare_cascade(forest, st, gate, X, device, atol,
                                 CASCADE_INVALID)
        worst_cascade = max(worst_cascade, err)
        _, counts = compare_cascade(core.quantize_forest(forest, X, QUANT),
                                    st, gate, X, device, atol,
                                    CASCADE_INVALID)
        print(f"cascade_qs_forward T={T_} L={L_} d={d_} C={C_} B={B_} "
              f"stages={st} {gate.tag()} {'votes' if votes else 'logits'} "
              f"(last {CASCADE_INVALID} rows invalid): exit stages "
              f"identical, int16 bit-exact (exits {counts.tolist()}), float "
              f"max|diff| {err:.3g}, two launches bit-identical")
    mnist = datasets.make_mnist()
    n_trees, max_leaves = CASCADE_FOREST
    t0 = time.perf_counter()
    rf = RandomForest(RandomForestConfig(n_trees=n_trees,
                                         max_leaves=max_leaves, seed=0))
    cforest = core.from_random_forest(rf.fit(mnist.X_train, mnist.y_train))
    print(f"trained mnist RF {n_trees}x{max_leaves} (d="
          f"{cforest.n_features}, C={cforest.n_classes}) on "
          f"{len(mnist.X_train)} rows in {time.perf_counter() - t0:.1f} s")
    n_cal = len(mnist.X_test) // 2
    reps = -(-N_REQUESTS // (len(mnist.X_test) - n_cal))
    crows = np.tile(mnist.X_test[n_cal:], (reps, 1))[:N_REQUESTS]
    cy = np.tile(mnist.y_test[n_cal:], reps)[:N_REQUESTS]
    t0 = time.perf_counter()
    casc = cascade_path(cforest, mnist.X_train, mnist.X_test[:n_cal],
                        mnist.y_test[:n_cal], crows, cy, device)
    cal = casc["calibration"]
    print(f"cascade main path ({time.perf_counter() - t0:.1f} s host wall "
          f"incl. quantize, compile, calibrate, serve): stages "
          f"{casc['stages']}, calibrated on {n_cal} rows (floor "
          f"{CASCADE_FLOOR_PP} pp): {cal.policy.tag()}, accuracy "
          f"{cal.accuracy:.4f} vs full {cal.full_accuracy:.4f}")
    tier1 = casc["tier1_launches"]
    print(f"served {N_REQUESTS} requests in {casc['n_batches']} batches "
          f"(mean {casc['mean_batch']:.1f} rows): fused "
          f"cascade_qs_forward launches {casc['launches']}, qs_forward 0; "
          f"staged qs_forward launches {casc['staged_launches']}, "
          f"cascade_qs_forward 0; tier-1 fused on engine=bitmm "
          f"qs_bitmm_forward launches {tier1['bitmm']}, on engine=gemm "
          f"gemm_forward launches {tier1['gemm']} (each once per stage "
          f"with survivors); tier-2 fused == staged == tier-1 bitmm == "
          f"tier-1 gemm bit for bit, scores and per-batch exit counts; "
          f"served == predict")
    print(f"exit fractions {[round(x, 4) for x in casc['exit_fractions']]},"
          f" mean trees per row {casc['mean_trees']:.2f} of {n_trees}; "
          f"served accuracy gated {casc['acc_gated']:.4f}, full forest "
          f"{casc['acc_full']:.4f}; disabled gate == bitvector engine; "
          f"ScoreBoundGate keeps every class")
    p50 = casc["compute_p50_ms"]
    print(f"cascade per batch, host clock: predict p50 fused "
          f"{p50['fused']:.3f} ms, staged {p50['staged']:.3f} ms, tier-1 "
          f"fused bitmm {p50['fused_bitmm']:.3f} ms, gemm "
          f"{p50['fused_gemm']:.3f} ms [{card}]")
    err_q, _ = compare_cascade(casc["qforest"], casc["stages"],
                               casc["policy"], crows[:B], device, ATOL_FULL)
    err_f, _ = compare_cascade(cforest, casc["stages"], casc["policy"],
                               crows[:B], device, ATOL_FULL)
    print(f"cascade_qs_forward full width T={n_trees} L={max_leaves} "
          f"d={cforest.n_features} C={cforest.n_classes} B={B}: exit "
          f"stages identical; int16 bit-exact ({err_q}); float max|diff| "
          f"{err_f:.3g} (atol {ATOL_FULL}); sweep float max|diff| "
          f"{worst_cascade:.3g} (rtol {RTOL}, atol {ATOL}, {ATOL_FULL} at "
          f"512 trees)")
    split = host_split(casc["fused"], crows[:round(casc["mean_batch"])],
                       device)
    print(f"one served fused mnist batch of {round(casc['mean_batch'])} rows "
          f"(bucket {split['bucket']}), host clock with a synchronize "
          f"after each step, median of 20: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()
                      if k != "bucket")
          + f"; sum {sum(v for k, v in split.items() if k != 'bucket'):.3f}"
          f" ms [{card}]")

    # 6. the compile slice: model files and the packed format, through the
    # optimizer middle-end, onto the forest kernels
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        packed = packed_path(qfull, msn.X_train, rows, device, tmpdir)
        wall = time.perf_counter() - t0
        opt_pred = packed["bitvector"]["pred"]
        print(f"compile slice: MSN int16 forest saved with io.save_forest, "
              f"compiled from the file at {SERVED_OPT} on backend=cuda "
              f"({opt_summary(qfull, opt_pred.forest)}) and served "
              f"{N_REQUESTS} requests per engine: "
              + ", ".join(f"{e} {r['launches']} launches for "
                          f"{r['n_batches']} batches"
                          for e, r in packed.items())
              + f"; no other kernel; served == -O0 in memory == plain torch "
              f"{SERVED_OPT} from the file, bit for bit, on every engine "
              f"({wall:.1f} s host wall)")
        print("compile slice: " + " → ".join(
            f"{r.name}[{r.detail}]" for r in opt_pred.plan.records
            if r.name.startswith("opt") or r.name == "deserialize"))
        path = os.path.join(tmpdir, "msn.repro.npz")
        for lvl in OPT_LEVELS:
            ms, _ = pass_times(path, device, msn.X_train, engine="bitvector",
                               backend="cuda", opt=lvl)
            print(f"compile passes, MSN file → bitvector/cuda at {lvl}, host "
                  f"ms: " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
                  + f"; total {sum(ms.values()):.2f} ms [{card}]")
        ms = opt_pass_times(qfull, msn.X_train)
        print(f"optimizer passes of {SERVED_OPT} on the MSN forest, host ms: "
              + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + f" [{card}]")

        t0 = time.perf_counter()
        mf = model_file_cascade(rf, cforest.n_features, mnist.X_train,
                                mnist.X_test[:n_cal], mnist.y_test[:n_cal],
                                crows, cy, device, tmpdir)
        wall = time.perf_counter() - t0
        qimported = core.quantize_forest(mf["imported"], mnist.X_train, QUANT)
        print(f"compile slice: mnist RF {n_trees}x{max_leaves} written as "
              f"sklearn-shim JSON ({os.path.getsize(mf['path'])} bytes), "
              f"compiled with quant int16 int-accum, opt={SERVED_OPT}, "
              f"cascade stages {mf['fused'].stages} fused, gate "
              f"{mf['policy'].tag()}: d {mf['imported'].n_features} → "
              f"{mf['fused'].forest.n_features} after drop_unused_features "
              f"({opt_summary(qimported, mf['fused'].forest)}); served "
              f"{N_REQUESTS} requests in {mf['n_batches']} batches, "
              f"cascade_qs_forward launches {mf['launches']}, no other "
              f"kernel; scores and exit counts == the staged {SERVED_OPT} "
              f"cascade in plain torch; full {SERVED_OPT} forest == -O0; "
              f"mean trees per row {mf['mean_trees']:.2f}, accuracy gated "
              f"{mf['acc']:.4f}, full {mf['acc_full']:.4f} ({wall:.1f} s "
              f"host wall)")
        fixtures = fixture_path(device)
        print(f"compile slice: {len({n for n, _, _ in fixtures})} golden "
              f"model files (tests/fixtures) on backend=cuda, engines "
              f"{sorted({e for _, e, _ in fixtures})}: expected predictions "
              f"within rtol {FIXTURE_RTOL} atol {FIXTURE_ATOL}, max|diff| "
              f"{max(d for *_, d in fixtures):.3g}, one launch per predict")
        saved = save_load_path(qfull, rows, device, tmpdir)
        print("compile slice: ForestServer.save → ForestServer.load("
              "device=None) of the MSN int16 forest, bit-identical "
              "predictions; first batch of "
              f"{MAX_BATCH} rows, host ms: " + "; ".join(
                  f"{e}/torch compile→first prediction "
                  f"{saved[e]['compile_ms']:.2f}, load→first prediction "
                  f"{saved[e]['load_ms']:.2f} ({saved[e]['bytes']} bytes)"
                  for e in SAVED_ENGINES)
              + f"; saving a cuda predictor raises ValueError ("
              f"{saved['cuda_error'][:60]}...) [{card}]")

    # 7. the LM slice: flash_forward against its plain version, then
    # smollm-360m served at full width
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for shape in FLASH_SWEEP:
        for dt in worst:
            worst[dt] = max(worst[dt], compare_flash(*shape, dt, device))
    cfg = get_config(LM_ARCH)
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    served_shape = (LM_BATCH, LM_PROMPT, LM_PROMPT, H, K, hd, True)
    served_err = {dt: compare_flash(*served_shape, dt, device)
                  for dt in worst}
    print(f"flash_forward: {len(FLASH_SWEEP)} sweep shapes, max|diff| f32 "
          f"{worst[torch.float32]:.3g} (tol {FLASH_TOL_F32}), bf16 "
          f"{worst[torch.bfloat16]:.3g} (tol {FLASH_TOL_BF16}); served shape "
          f"B*H={LM_BATCH * H} S={LM_PROMPT} hd={hd} causal GQA {H}/{K}: f32 "
          f"{served_err[torch.float32]:.3g}, bf16 "
          f"{served_err[torch.bfloat16]:.3g}; two launches bit-identical")
    prompts = lm_prompts(cfg, LM_BATCH, LM_PROMPT)
    t0 = time.perf_counter()
    lm = lm_path(cfg, prompts, LM_NEW, device)
    t_lm = lm["times"]
    gen_ms = t_lm["prefill_ms"] + t_lm["decode_ms"]
    print(f"LM main path ({time.perf_counter() - t0:.1f} s host wall incl. "
          f"init, 6 generates, 4 prefills, teacher forcing): {cfg.name} "
          f"{cfg.n_layers} layers d={cfg.d_model} heads {H}/{K} hd={hd} "
          f"vocab {cfg.vocab}, {cfg.param_count()} params (seeded, bf16 on "
          f"backend=cuda); LMServer(batch={LM_BATCH}, max_len="
          f"{LM_PROMPT + LM_NEW + 1}).generate({LM_BATCH}x{LM_PROMPT} "
          f"prompts, n_new={LM_NEW}): flash_forward launches "
          f"{lm['launches']} (one per attention layer; by route "
          f"{lm['routes']}), no other kernel")
    print(f"LM checks: f32 greedy tokens cuda == torch ({LM_BATCH}x{LM_NEW})"
          f"; prefill logits cuda vs torch max|diff| / max|logit|: f32 "
          f"{lm['err32']:.3g} (tol {LM_LOGIT_TOL_F32}), bf16 "
          f"{lm['err16']:.3g} (tol {LM_LOGIT_TOL_BF16}); bf16 cuda vs f32 "
          f"torch {lm['err16_vs32']:.3g}; teacher-forced decode vs forward "
          f"({lm['steps']} steps, f32) max|diff| {lm['dec_err']:.3g} (tol "
          f"{LM_DECODE_TOL})")
    print(f"LM served (bf16, host clock around synchronised calls, second "
          f"call): prefill {t_lm['prefill_ms']:.2f} ms, decode "
          f"{t_lm['decode_ms'] / LM_NEW:.3f} ms per token, "
          f"{LM_BATCH * LM_NEW / gen_ms * 1e3:.1f} generated tokens/s "
          f"({LM_BATCH * (LM_PROMPT + LM_NEW) / gen_ms * 1e3:.0f} tokens/s "
          f"with the prompt); first call prefill "
          f"{lm['times_cold']['prefill_ms']:.2f} ms, decode "
          f"{lm['times_cold']['decode_ms'] / LM_NEW:.3f} ms per token "
          f"[{card}]")

    # 8. timings at the main paths' full-width kernel shapes.  ms and
    # library_ms: an eager loop of calls (cuda_ms), the host's work per
    # call included.  device_ms and library_device_ms: the same calls
    # replayed from one CUDA graph (graph_ms), the device's time alone
    records = []
    for k in KERNELS:
        x, arrays, kw = kernel_inputs(k, qfull, rows[:B], device)
        ms = cuda_ms(lambda: k.launch(x, *arrays, **kw), 200)
        device_ms = graph_ms(lambda: k.launch(x, *arrays, **kw), 200)
        plain_ms = cuda_ms(lambda: k.plain(x, *arrays, **kw), 10)
        bound_ms, bound_by, nbytes, n_ops = bound(k, x, arrays, kw)
        fx, farrays, fkw = kernel_inputs(k, full, rows[:B], device)
        float_ms = cuda_ms(lambda: k.launch(fx, *farrays, **fkw), 200)
        print(f"{k.source_name} B={B} T={T} L={L} d={d} int16/int32-accum: "
              f"kernel {ms:.4f} ms (eager loop; on the device by graph "
              f"replay {device_ms:.4f} ms), plain torch {plain_ms:.4f} ms, "
              f"bound {bound_ms:.5f} ms by {bound_by} ({nbytes} bytes, "
              f"{n_ops} ops); float forest (f32 accumulation) {float_ms:.4f}"
              f" ms; no single PyTorch call computes this function [{card}]")
        records.append({
            "name": k.source_name, "route": "cuda",
            "source": k.launch.source, "replaces": k.launch.replaces,
            "launches": launches[k.engine],
            "max_abs_err": full_err[k.engine], "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_device_ms": None})

    x, valid, arrays, kw = cascade_operands(
        casc["qforest"], casc["stages"], casc["policy"], crows[:B], device)
    shape = (x.shape[1], arrays[0].shape[1], arrays[2].shape[-1],
             arrays[-1].shape[1], arrays[-1].shape[-1],
             int(kw["out_dtype"] == torch.int32))
    held = {g: resident_clusters(dataclasses.replace(
        cascade_layout(*shape[:3], shape[4]), cluster=g), *shape)
        for g in range(1, 9)}
    lay = cascade_layout(*shape[:3], shape[4], sm_count(0),
                         lambda lay: held[lay.cluster])
    print(f"cascade_qs_forward layout at the mnist shape: clusters of "
          f"G={lay.cluster} blocks per 32-row tile, route {lay.route}, ring "
          f"chunk {lay.chunk} trees, {lay.shared_bytes} shared bytes, "
          f"{lay.blocks_per_sm} block(s) per SM; the card holds clusters of "
          f"G blocks at once (cudaOccupancyMaxActiveClusters) {held}; the "
          f"served fused run's launches by route {casc['routes']}")
    ms = cuda_ms(lambda: cascade_qs_forward(x, valid, *arrays, **kw), 200)
    device_ms = graph_ms(lambda: cascade_qs_forward(x, valid, *arrays, **kw),
                         200)
    plain_ms = cuda_ms(
        lambda: cascade_qs_forward_reference(x, valid, *arrays, **kw), 10)
    _, exit_stage = cascade_qs_forward(x, valid, *arrays, **kw)
    bound_ms, bound_by, nbytes, n_ops, reach = cascade_bound(
        x, valid, arrays, kw, exit_stage, casc["stages"])
    exited = exited_pair_share(valid, exit_stage, kw["stage_bounds"])
    qx, qarrays, qkw = kernel_inputs(KERNELS[0], casc["qforest"], crows[:B],
                                     device)
    qs_ms = cuda_ms(lambda: qs_forward(qx, *qarrays, **qkw), 200)
    qs_device_ms = graph_ms(lambda: qs_forward(qx, *qarrays, **qkw), 200)
    qs_bound_ms, qs_by, _, qs_ops = bound(KERNELS[0], qx, qarrays, qkw)
    print(f"cascade_qs_forward B={B} T={n_trees} L={max_leaves} "
          f"d={cforest.n_features} C={cforest.n_classes} int16/int32-accum, "
          f"{casc['policy'].tag()}, rows reaching each stage {reach}: "
          f"kernel {ms:.4f} ms (eager loop; on the device by graph replay "
          f"{device_ms:.4f} ms), plain torch {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by} ({nbytes} bytes, {n_ops} ops); "
          f"{exited:.1%} of the (row, tree) pairs walked are exited rows' "
          f"(32-row tiles, no compaction); qs_forward over all {n_trees} "
          f"trees {qs_ms:.4f} ms (on the device by graph replay "
          f"{qs_device_ms:.4f} ms; bound {qs_bound_ms:.5f} ms by {qs_by}, "
          f"{qs_ops} ops); no single PyTorch call computes this function "
          f"[{card}]")
    records.append({
        "name": "cascade_qs_forward", "route": "cuda",
        "source": cascade_qs_forward.source,
        "replaces": cascade_qs_forward.replaces,
        "launches": casc["launches"],
        "max_abs_err": max(err_q, err_f), "ms": ms, "device_ms": device_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library_device_ms": None})
    # the same kernel on the compile slice's -O2 cascade (reordered trees,
    # its own calibrated gate) on the same rows
    ofused = mf["fused"]
    x, valid, arrays, kw = cascade_operands(
        ofused.forest, ofused.stages, ofused.policy, crows[:B], device)
    o2_device_ms = graph_ms(
        lambda: cascade_qs_forward(x, valid, *arrays, **kw), 200)
    _, exit_stage = cascade_qs_forward(x, valid, *arrays, **kw)
    o2_bound_ms, o2_by, _, _, o2_reach = cascade_bound(
        x, valid, arrays, kw, exit_stage, ofused.stages)
    print(f"cascade_qs_forward B={B} on the {SERVED_OPT} mnist cascade from "
          f"the model file ({ofused.policy.tag()}), rows reaching each stage "
          f"{o2_reach}: on the device by graph replay {o2_device_ms:.4f} ms "
          f"(-O0 cascade above {device_ms:.4f} ms), bound {o2_bound_ms:.5f}"
          f" ms by {o2_by}; "
          f"{exited_pair_share(valid, exit_stage, kw['stage_bounds']):.1%} "
          f"of the walked pairs are exited rows' [{card}]")

    flash_ms = {}
    for name, (B_, S_) in (("served", (LM_BATCH, LM_PROMPT)),
                           ("32k", (1, LONG_S))):
        q, k, v = flash_inputs(B_, S_, S_, H, K, hd, torch.bfloat16, device)
        q4, k4, v4 = (t.view(B_, -1, S_, hd) for t in (q, k, v))
        reps = 50 if name == "served" else 3
        ms = cuda_ms(lambda: flash_forward(q, k, v, n_rep=H // K), reps)
        device_ms = graph_ms(lambda: flash_forward(q, k, v, n_rep=H // K),
                             reps)
        lib, lib_form = library_attention(q4, k4, v4)
        with sdpa_kernel(FUSED_SDPA):
            lib_ms = cuda_ms(lib, 10 * reps)
            lib_device_ms = graph_ms(lib, reps)
            lib_out = lib()
        plain_ms = cuda_ms(lambda: flash_forward_reference(
            q, k, v, n_rep=H // K), 5) if name == "served" else None
        lib_err = float((flash_forward(q, k, v, n_rep=H // K).view_as(q4)
                         .float() - lib_out.float()).abs().max())
        if lib_err > FLASH_TOL_BF16:
            raise AssertionError(f"flash {name}: kernel vs SDPA max |diff| "
                                 f"{lib_err}")
        bound_ms, bound_by, nbytes, n_ops = flash_bound(q, k, v, True)
        flash_ms[name] = dict(ms=ms, device_ms=device_ms, lib_ms=lib_ms,
                              lib_device_ms=lib_device_ms,
                              plain_ms=plain_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        print(f"flash_forward {name} B={B_} H={H}/{K} S={S_} hd={hd} bf16 "
              f"causal: kernel {ms:.4f} ms (eager loop; on the device by "
              f"graph replay {device_ms:.4f} ms), plain torch "
              f"{'not timed' if plain_ms is None else f'{plain_ms:.4f} ms'}"
              f", scaled_dot_product_attention ({lib_form}) {lib_ms:.4f} ms"
              f" (on the device {lib_device_ms:.4f} ms; max|diff| vs kernel "
              f"{lib_err:.3g}), bound {bound_ms:.5f} ms by {bound_by} "
              f"({nbytes} bytes, {n_ops} ops); kernel "
              f"{n_ops / ms / 1e9:.2f} TFLOP/s [{card}]")
    q, k, v = flash_inputs(LM_BATCH, LM_PROMPT, LM_PROMPT, H, K, hd,
                           torch.float32, device)
    f32_ms = cuda_ms(lambda: flash_forward(q, k, v, n_rep=H // K), 20)
    f32_device_ms = graph_ms(lambda: flash_forward(q, k, v, n_rep=H // K),
                             20)
    print(f"flash_forward served shape in f32 (route simt, the CUDA-core "
          f"kernel): {f32_ms:.4f} ms (eager loop; on the device by graph "
          f"replay {f32_device_ms:.4f} ms) [{card}]")
    served_t = flash_ms["served"]
    records.append({
        "name": "flash_forward", "route": "cuda",
        "source": flash_forward.source, "replaces": flash_forward.replaces,
        "launches": lm["launches"],
        "max_abs_err": served_err[torch.bfloat16], "ms": served_t["ms"],
        "device_ms": served_t["device_ms"], "plain_ms": served_t["plain_ms"],
        "bound_ms": served_t["bound_ms"], "bound_by": served_t["bound_by"],
        "library_ms": served_t["lib_ms"],
        "library_device_ms": served_t["lib_device_ms"]})

    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
