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
    then the input transform ``quantize_rows`` against its plain torch
    version on the same card tensors and against the host's
    ``quantize_inputs(...).astype(float32)``, bit for bit, f32 and f64
    callers, at the cells' shapes (MSN 8192 x 136, magic 65,536 x 10, the
    query buckets 128-1024 holding 8, 100 or 1024 rows), with NaN, ±inf
    and -0.0 in the rows, on the int16 and the control's int8 grid and
    through a ``feat_map``;
 4. the main path at full width: an MSN-shaped ranking forest (1024 trees
    × 64 leaves × 136 features), quantized int16 with int-accum and
    calibrated on MSN rows, compiled with ``backend="cuda"`` for each of
    the engines ``bitvector``, ``bitmm`` and ``gemm`` and served through
    ``ForestServer(max_batch=1024)``; served output must equal synchronous
    ``predict``, each engine's kernel launches the batches (on its
    shared-memory-x route only), ``quantize_rows`` once per served batch
    (the rows are quantized on the card), and the three engines' served
    outputs
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
    stage with survivors); each fused run quantizes on the card
    (``quantize_rows`` once per batch), the staged one on the host (no
    launch): all four bit-identical, scores and exit counts,
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
 7. the autotuner (``core.engine_select``): ``choose`` on the MSN int16
    forest at batch 1024 over the nine engines (six torch engines and the
    three kernels) as-is and at -O2, 18 candidates timed by the host
    clock around ``predict`` (each ``cuda-*`` kernel must launch in the
    sweep; the winner equals plain torch bit for bit); a second process
    loads the forest from its file and must answer from the same cache
    file with no sweep; ``ForestServer.from_forest`` serves the 4096 rows
    from the cache, bit-identical to phase 4, and
    ``compile_forest(tune="measure")`` builds the same engine; the mnist
    cascade's candidates (cuda-qs and qs, as-is, staged and fused with
    the calibrated gate; ``cascade_qs_forward`` and ``qs_forward`` launch)
    and a winner serving as phase 5 did; measured sweeps over a ladder of
    random shapes, a cost model trained from the cache
    (``tune.train_from_cache``) and ``choose(mode="-Os")`` on two held-out
    shapes, the winner bit-exact against plain torch.  Every candidate's
    time is printed beside the card's name and power limit;
 8. the LM slice: hold ``flash_forward`` against its plain version at the
    reference's sweep (f32, 2e-5), in bf16 (3e-2), at the served shape
    in both, and with a query offset (``q_offset``) at phase 18's "seq"
    rank shape (smollm-360m's 15/5 heads at hd 64, 2 rows, 256 queries at
    offsets 0 and 256 over 512 keys) in both, two launches
    bit-identical; then serve smollm-360m at full
    width (32 layers, d 960, 15/5 heads, vocab 49152; seeded random
    weights in bf16) through ``LMServer(batch=8, max_len=1057)
    .generate(8 prompts x 1024 tokens, n_new=32)`` on ``backend="cuda"``:
    one ``flash_forward`` launch per attention layer of the one-pass
    prefill, every one on the bf16 ``wgmma`` route, and no other kernel;
    in f32 at the same weights ``cuda`` and
    ``torch`` give the same greedy tokens and close prefill logits, so do
    the bf16 prefill logits, and teacher-forced ``decode_step`` matches
    ``Model.forward``;
 9. the serving runtime: one ``ServingRuntime`` holds four tenants, the
    phase-4 MSN int16 forest on each kernel engine (``msn-qs``,
    ``msn-bitmm``, ``msn-gemm``) and phase 5's fused mnist cascade, all
    at ``max_batch=1024``, warmed over ``bucket_ladder(1024)``; the 4096
    MSN rows (spread over the three MSN tenants) and the 4096 mnist rows,
    interleaved, arrive open-loop (Poisson, ``RUNTIME_RATE_HZ`` on the
    real clock) and the worker thread serves them while a second thread
    scrapes ``/metrics`` and ``/traces`` over loopback.  A first,
    unthrottled run gives ``msn-qs`` its p99, which the served run takes
    as its ``SLOConfig`` target.  Served == each tenant's synchronous
    ``predict`` bit for bit, the MSN rows == phase 4, the cascade's exit
    counts == phase 5; each kernel launched once per batch of its tenant
    on the x-tile route, no other kernel; no compile event or retrace
    anomaly after warmup; the scrape lists all 13 catalog metrics with
    the request and batch counters of ``stats()``; every request
    answered once.  Then ``from_forests`` with phase 7's cache (no
    sweep, bit-identical), a fleet of torch-engine tenants saved and
    loaded onto the card (bit-identical; saving a ``cuda`` tenant
    raises), and ``repro_torch.launch.serve`` in each mode, in process.
    Per tenant its p50 / p99, the mean of each phase, batches, mean batch
    and the controller's decisions, the rate served and the phase's wall
    time are printed beside the card's name and power limit;
10. tree-sharded execution (``core.shard``): phase 4's MSN int16 forest
    on every shardable torch engine over ``devices=[cuda:0] * D`` for D in
    1, 3 and 4, bit-identical to the unsharded engine and to the
    ``qs_forward`` predictor (no kernel launches: the shards run the torch
    engines), the float forest within tolerance, and ``n_devices=2``
    refused on one card (too few devices; ``backend="cuda"``); sharded and
    unsharded predict ms beside the card's name and power limit;
11. the moe, ssm and hybrid LM families served as smollm-360m is in phase
    8: mamba2-370m at its published size, phi3.5-moe at full width with
    its depth cut to 4 layers, jamba-1.5-large at ``.reduced()``; one
    ``flash_forward`` launch per attention layer of the prefill (none for
    mamba2), the f32 and bf16 checks of phase 8 and the MoE routes that
    differ between the attention engines; prefill and decode ms per token
    beside the card's name and power limit;
12. time each kernel and its plain version with CUDA events, as an
    eager loop of calls, beside the least time the card could take for
    the same work (``quantize_rows`` at the MSN bulk call, 8192 x 136,
    and the magic cascade's, 65,536 x 10, bound by bytes; the kernels and
    SDPA also replayed from one CUDA graph,
    the device's time without the host's work per call, in ``device_ms``
    and ``library_device_ms``; ``flash_forward`` also beside
    ``scaled_dot_product_attention``, at the served shape, at
    ``prefill_32k``'s per-sequence shape, S = 32768, and at phase 13's
    non-causal shapes — seamless's encoder (B·H = 128, S = 1024) and its
    cross-attention (16 queries over 1024 frames) — and at phase 18's
    "seq" rank shape with its query offset (``seq_rank``: 256 queries at
    offset 256 over 512 keys, SDPA over K/V cut to the chunk's last key
    under ``causal_lower_right``), and its f32 route at the served
    shape; ``cascade_qs_forward`` beside ``qs_forward`` over
    the mnist cascade's 512 trees, with its cluster layout and the share
    of walked pairs that belong to exited rows);
13. the encoder-decoder family and the int8 KV cache: ``flash_forward``
    against its plain version at the encoder and cross shapes (f32 and
    bf16); seamless-m4t-large-v2 at its published size (24 + 24 layers,
    1.63 B seeded parameters) served in bf16 on ``backend="cuda"``
    through ``Model.init_decode_state(params=, enc_embeds=)`` (8
    utterances of 1024 seeded frames), ``prefill`` with that state (8
    prompts of 16 tokens) and 32 greedy ``decode_step`` calls: 24
    non-causal launches in the encode, 24 causal and 24 cross launches in
    the prefill, 72 in all, every one ``wgmma``, no other kernel; in f32
    ``cuda`` and ``torch`` give the same greedy tokens and close prefill
    logits, so do the bf16 prefill logits, and teacher-forced
    ``decode_step`` matches ``forward``; then smollm-360m through
    ``LMServer(batch=8, max_len=1057, kv_quant=True)``: 32 ``wgmma``
    launches per prefill, f32 tokens ``cuda`` == ``torch``, the state at
    most ``KV_QUANT_BYTES`` of the bf16 state's bytes, and decode ms per
    token beside the bf16 cache's;
14. training (``launch/train.py``), with every launch count set to 0
    first: smollm-360m at full width on ``Trainer(batch=4,
    seq_len=4096)`` (``train_4k``'s sequence length, its batch cut 256 →
    4), 3 steps in bf16 with f32 masters and f32 Adam moments: finite
    losses and grad norms, the first loss within 0.2–3 × ln V, grad norm
    > 0; ms per step (steps 2–3), tokens/s, peak memory and 6·N·tokens
    per step time as a share of the bf16 peak.  The restart contract at
    the reference CLI's defaults (8 × 256): 4 steps equal 2 steps,
    ``save``, a new trainer's ``restore`` and 2 more, and equal
    ``run_loop`` resuming from that checkpoint (it writes its own
    checkpoint, a heartbeat and the JSONL log): losses, params and
    moments bit for bit, with the checkpoint's save and restore seconds.
    A fourth full-width step runs under ``FlopCounterMode`` (phase 17
    reads its count).
    Two steps each with int8 moments and with compressed gradients
    (finite), the int8 state's bytes against the f32 state's.  The loss
    and gradients of the reduced config in f32 on the card against the
    same trainer on the CPU (``TRAIN_LOSS_RTOL``, ``TRAIN_GRAD_TOL``).
    No kernel launches in any of it: training runs ``backend="torch"``.
15. data-parallel training (``Trainer(mesh=)``), with every launch count
    set to 0 first: a one-rank NCCL group on the card
    (``launch.cluster.initialize_from_env`` over a free localhost port,
    an explicit timeout; the host has one card and NCCL takes one rank a
    card) and ``make_debug_mesh(1, 1)``; phase 14's runs through the
    mesh, each bit for bit the mesh-less run (losses, grad norms, params;
    an all-reduce over one rank and a division by 1 change no bit):
    smollm-360m at 4 × 4096 for 3 steps (ms, tokens/s, the all-reduce's
    ms by CUDA events and its bytes, peak memory against phase 14's), the
    restart contract at 8 × 256 (save at step 2, a new trainer's restore,
    2 more), int8 moments and compressed gradients 2 steps each; then
    ``compressed_psum`` over NCCL on card tensors, bit for bit its plain
    version on the CPU; the group is destroyed at the end.  No kernel
    launches.
16. tensor-parallel training (``Trainer(mesh=)`` with a "model" axis),
    with every launch count set to 0 first: four spawned ranks share the
    one card and join a gloo group (NCCL takes one rank a card), with a
    collective timeout and a join timeout; each builds its (2, 2) and
    (1, 4) ``Mesh`` itself (a CPU ``DeviceMesh`` of gloo groups, the card
    as the mesh's device).  A rehearsal of the exchanges with the card's
    compute, not a measure of them: gloo stages each collective through
    host memory.  The ranks probe every collective the port calls on card
    tensors; then (a) smollm-360m at full width and depth on (2, 2) and
    (1, 4), (b) mamba2-370m at its published size and (c) phi3-mini-3.8b
    at its published width with its depth cut 32 -> 2, both on (1, 4),
    each at 4 x 1024 in bf16 for 2 steps: step 0's loss within 2^-8 of
    the mesh-less trainer's on the card and the gathered gradient's
    cosine with its gradient at least 0.999, and per rank the stored f32
    param bytes beside ``launch.dryrun._analytic_memory``'s "params"
    term, the Adam state's bytes, peak memory, ms per step and the bytes
    each collective kind moved; (d) the five families' .reduced() in f32
    on (2, 2) against the mesh-less trainer on the card (step 0 rel 1e-5,
    steps 1-2 1e-3) and a (2, 2) checkpoint restored on (1, 4) (rtol
    1e-4).  With four cards the ranks run again over NCCL, one a card;
    with fewer it prints that this did not run.  No rank launches a
    kernel; every kernel record gains ``tp_launches`` (0) and a
    ``{"tensor_parallel": ...}`` line follows the data-parallel line.
17. the dry run of the training cells, no card and no JAX in it: in
    processes on the host's cores (``DRYRUN_ARCHS``, the longest
    first), (a) ``python -m repro_torch.launch.dryrun --arch A --shape
    train_4k --mesh M`` for the ten architectures on the (16, 16) mesh and
    for ``DRYRUN_MULTI_ARCHS`` on (2, 16, 16) (the other nine were cut for
    time when phase 19 came), each on a fake world of 256 or 512 ranks with its
    step traced on meta tensors: per cell the status (an ``error`` fails),
    arguments plus temporaries in GiB against the card's 80 GiB, the
    compute, memory and collective ms of the roofline (H100 datasheet
    constants), the dominant term and ``trace_s``; (b) phase 14's own
    cell (smollm-360m, 4 x 4096, bf16, remat) on a one-rank mesh: its
    FLOPs equal the ``FlopCounterMode`` count of a step of phase 14's,
    and its arguments plus temporaries lie within ``DRYRUN_PEAK_BAND`` of
    phase 14's ``torch.cuda.max_memory_allocated``; (c) the serving cells
    on the (16, 16) mesh: ``--shape prefill_32k``, ``decode_32k`` and
    ``long_500k`` for every architecture, the decode and long-context
    cells also with ``--kv-quant``: each ``ok``, or ``skipped`` where the
    reference skips it (long_500k on pure full-attention architectures).
    No kernel launches; the kernel records are unchanged and a
    ``{"dry_run": ...}`` line follows the tensor-parallel line.
18. sharded serving (``launch.serve_step.ServeStep``: ``Model.prefill``
    and ``decode_step`` on a live mesh), four spawned ranks on the one
    card over gloo as in phase 16, each holding only its shards of the
    bf16 weights and of the decode state: (a) phi3-mini-3.8b at its
    published size on (1, 4) ("heads" attention: ``flash_forward`` on the
    rank's 8 of 32 heads at hd 96, one launch per attention layer per
    rank in the prefill, all ``wgmma``), 4 x 1024 prompts then 16 tokens;
    (b) smollm-360m at its published size on (2, 2) ("seq" attention:
    ``flash_forward`` on the rank's query chunk at its ``q_offset``, one
    ``wgmma`` launch per layer per rank; its cache split over head_dim,
    the batch over the data axis) and (c) mamba2-370m at its published
    size on (1, 4) (its SSD heads and conv window split, no kernel
    launch), each 4 x 512 then 8 tokens; (d) every family's .reduced()
    in f32 on (2, 2), the
    attention families also with the int8 cache.  Each case is held to
    the mesh-less ``ServeStep`` on the card: the prefill's last logits
    and each decode step's, teacher-forced with the mesh-less run's
    greedy tokens, within ``SERVE_BF16_STEPS`` bf16 steps of the largest
    |logit| in bf16 (beside the mesh-less step's own spread,
    ``serve_tp_floors``) and within the CPU tests' bounds in f32; the
    greedy tokens that agree, launches by route per rank, and prefill and
    decode ms (gloo stages the exchanges through host memory: no speed
    conclusion).
    Then ``flash_forward`` at (a)'s per-rank shape against its plain
    version and timed beside SDPA.  Every kernel record gains
    ``serve_tp_launches`` and a ``{"sharded_serving": ...}`` line
    follows the dry-run line.
19. the reference's five examples as the port's entry points
    (``examples/torch_*.py``), each through its ``main`` in this process
    on the card at the reference's default sizes, its own assertions the
    checks: the quickstart (magic, RF 128 x 32; every torch engine float
    and int16, then ``qs_forward`` on the int16 forest bit for bit the
    torch engine's), the serving example twice (mnist, RF 128 x 64 int16;
    ``ForestServer.from_forest`` sweeps nine candidates, the three
    forest kernels launch; 2000 Poisson requests; the second run answers
    from the cache file with the same engine, batches and accuracy), the
    ranking example (msn, GBT 300 x 32: every torch engine's NDCG@10
    within 1e-6 of the trainer's), the LM training example (smollm-14m,
    300 steps of 8 x 128, checkpoints in a temporary directory: the loss
    falls) and the elastic restart (losses within 1e-3 of the
    uninterrupted run).  Per run its seconds, returned numbers and
    launches by kernel and route; every kernel record gains
    ``examples_launches`` and ``examples_launches_by_route``, and an
    ``{"examples": ...}`` line follows the sharded-serving line.

It prints one JSON line of kernel records, the card's line, and last
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and the last line is never printed; so it is without a
CUDA device, and where ``src/repro_torch`` is missing.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import datetime
import gc
import itertools
import json
import math
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import defaultdict
from io import StringIO

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import torch  # noqa: E402

import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402
from torch.nn.attention import SDPBackend, sdpa_kernel  # noqa: E402

from repro_torch import core, io, optim, tune  # noqa: E402
from repro_torch.cascade import (CascadeSpec, MarginGate,  # noqa: E402
                                 ProbaGate, ScoreBoundGate, calibrate)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import engine_select, pipeline, shard  # noqa: E402
from repro_torch.core.engine_select import bucket_batch  # noqa: E402
from repro_torch.data import datasets  # noqa: E402
from repro_torch.data.tokens import (SyntheticTokens,  # noqa: E402
                                     TokenPipelineConfig)
from repro_torch.inference import (ForestServer, LMServer,  # noqa: E402
                                   ServingRuntime, SLOConfig)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.cascade_kernel import (  # noqa: E402
    cascade_layout, cascade_qs_forward, cascade_qs_forward_reference,
    resident_clusters)
from repro_torch.kernels.launch import TILE_ROWS, sm_count  # noqa: E402
from repro_torch.kernels.flash_attention_kernel import (  # noqa: E402
    flash_forward, flash_forward_reference)
from repro_torch.models import Model, moe  # noqa: E402
from repro_torch.obs import trace  # noqa: E402
from repro_torch.models.model import tree_flatten, tree_map  # noqa: E402
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.cluster import initialize_from_env  # noqa: E402
from repro_torch.launch.dryrun import _model_flops  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh  # noqa: E402
from repro_torch.launch.specs import enc_len  # noqa: E402
from repro_torch.distributed import checkpoint as ckpt  # noqa: E402
from repro_torch.distributed.compression import (  # noqa: E402
    compressed_psum, compressed_psum_reference)
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.distributed.fault_tolerance import Heartbeat  # noqa: E402
from repro_torch.obs import (METRIC_CATALOG, PHASES,  # noqa: E402
                             MetricsRegistry, get_registry,
                             set_default_registry)
from repro_torch.kernels.gemm_forest_kernel import (  # noqa: E402
    gemm_forward, gemm_forward_reference)
from repro_torch.kernels.quantize_kernel import (  # noqa: E402
    quantize_rows, quantize_rows_reference)
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
# the benchmark control's grid: int8 inputs
QUANT8 = core.QuantSpec(bits=8)
# (rows, bucket) of quantize_rows over the MSN forest: the bulk call and
# the query cell's buckets; the magic cascade's call is MAGIC_ROWS x 10
QUANTIZE_MSN = [(8192, 8192)] + [(n, b) for b in (128, 256, 512, 1024)
                                 for n in (8, 100, 1024) if n <= b]
MAGIC_ROWS = 65536
# the mnist cascade cell's call: 8-bit pixel rows of 784 features
# (chipbench/traffic/bulk_16384.json), widened to float64 by the feed
MNIST_ROWS = 16384
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
# the mnist cascade's shape on a random forest, at 1024 rows and at the
# mnist cell's 16384-row bucket: every entry of
# tests/test_torch_cuda.py's CASCADE_SHAPES, three more batches, and a
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
    (512, 64, 784, 10, 16384, (16, 64, 256, 512), MarginGate(0.3), False),
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
# the autotuner (phase 7): the MSN forest swept over every engine (the six
# torch engines and the three kernels) as-is and at -O2; the mnist cascade
# raced staged and fused on cuda-qs and qs; a ladder of random int16 shapes
# (T 64..1024, L 16 or 64, d 16..784, C 1 or 10) at batch 256 trains the
# -Os cost model, asked on two held-out shapes, the first at the default
# confidence threshold and the second at 0 (always the zero-shot path)
AUTOTUNE_OPT = (2,)
TUNE_KERNELS = {"cuda-qs": "bitvector", "cuda-bitmm": "bitmm",
                "cuda-gemm": "gemm"}
CASCADE_TUNE_ENGINES = ("cuda-qs", "qs")
PREDICT_ENGINES = ("cuda-qs", "cuda-bitmm", "cuda-gemm", "qs", "gemm")
PREDICT_BATCH = 256
PREDICT_LADDER = [(64, 16, 16, 1), (128, 64, 136, 1), (256, 16, 784, 10),
                  (512, 64, 64, 10), (1024, 16, 136, 1), (96, 64, 784, 1),
                  (768, 64, 32, 10), (192, 16, 300, 1)]
PREDICT_HELD_OUT = [(384, 64, 100, 1), (160, 16, 500, 10)]
PREDICT_THRESHOLDS = (0.8, 0.0)
# the serving runtime (phase 9): the MSN forest on each kernel engine and
# the fused mnist cascade, four tenants of one ServingRuntime, served under
# open-loop Poisson arrivals on the real clock (the rate is the fleet's
# total; max_batch = MAX_BATCH for every tenant); msn-qs carries an SLO
# whose p99 target is the fleet's own unthrottled p99; the launcher's
# forest and runtime modes train magic forests of LAUNCH_TREES trees
MSN_TENANTS = {"msn-qs": "bitvector", "msn-bitmm": "bitmm",
               "msn-gemm": "gemm"}
MNIST_TENANT = "mnist-cascade"
SLO_TENANT = "msn-qs"
RUNTIME_RATE_HZ = 8000.0
RUNTIME_WAIT_MS = 2.0
RUNTIME_TIMEOUT_S = 120.0
LAUNCH_TREES = 32
# run by a second process: the same choose() on the forest loaded from its
# file, against the same cache file
CACHE_HIT_CHILD = r"""
import json, sys
src, forest_path, cache, batch, device = sys.argv[1:6]
sys.path.insert(0, src)
from repro_torch import io
from repro_torch.core import engine_select
from repro_torch.obs import get_registry
choice = engine_select.choose(
    io.load_forest(forest_path), int(batch), device=device,
    engines=engine_select.default_engines(True, device),
    opt_levels=(2,), cache_path=cache)
print(json.dumps({"from_cache": choice.from_cache, "engine": choice.engine,
                  "sweeps": get_registry().get(
                      "repro_autotune_sweeps_total").value}))
"""
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
# the encdec shapes in bf16 are held tighter: within two bf16 steps of the
# largest |out| (a step is 2^-7 of the power of two at or under it).  The
# kernel and the plain version round one f32 result to bf16, at most a
# step apart, and the kernel's bf16 probabilities move it by ~2^-9 of |v|;
# a dropped key tile or one mis-masked key moves it by ten steps or more
FLASH_BF16_STEPS = 2
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
# the tree-sharded forest: every shardable torch engine at D shards, all
# on cuda:0 (the card host has one card), at phase 4's MSN int16 forest
SHARD_COUNTS = (1, 3, 4)
SHARD_REPS = 20
# the moe, ssm and hybrid LM families, served through LMServer as
# smollm-360m is: mamba2-370m at its published size (48 blocks, d 1024,
# state 128, headdim 64; configs/mamba2_370m.py); phi3.5-moe at full width
# (d 4096, 16 experts of d_ff 6400, top-2, GQA 32/8, vocab 32064) with its
# depth cut from 32 to 4 layers (one layer holds 1.30 B parameters: four
# with the embeddings are 22 GB of f32 weights and 11 GB in bf16); jamba
# at .reduced() (one full-width MoE layer alone is 39 GB in f32), which
# drives the hybrid layout.  B*S passes 256 prompt tokens for the MoE
# families, where a one-pass forward would apply GShard's capacity
LM_FAMILIES = {
    "mamba2_370m": dict(batch=4, prompt=300, new=16, layers=None,
                        reduced=False),
    "phi3_5_moe_42b": dict(batch=2, prompt=192, new=16, layers=4,
                           reduced=False),
    "jamba_1_5_large_398b": dict(batch=2, prompt=160, new=16, layers=None,
                                 reduced=True),
}
# the encoder-decoder family (phase 13): seamless-m4t-large-v2 at its
# published size (24 encoder and 24 decoder layers, d 1024, 16/16 heads,
# hd 64, d_ff 8192 gelu, vocab 256206; configs/seamless_m4t_large_v2.py).
# Its speech frontend is a stub: each of the B utterances is enc_len(4096)
# = 1024 frames of seeded embeddings (repro/launch/specs.py:13-15); the
# decoder prompts are 16 tokens, then 32 greedy tokens
ENCDEC_ARCH = "seamless_m4t_large_v2"
ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_NEW, ENCDEC_SEQ = 8, 16, 32, 4096
# the int8 KV cache (phase 13): smollm-360m served as phase 8 serves it;
# its decode state at most this share of the bf16 state's bytes ((1 +
# 4/64) / 2 = 0.53 at hd 64: an int8 value and an f32 scale per head row)
KV_QUANT_BYTES = 0.55
# training (phase 14): smollm-360m at full width.  train_4k (S 4096, batch
# 256, models/config.py) with its batch cut to 4 sequences; the restart
# contract, int8 state and compressed gradients at the reference CLI's
# defaults (batch 8, seq-len 256, src/repro/launch/train.py:264-265); the
# card against the CPU on .reduced() in f32, at the CPU parity tests'
# tolerances (tests/test_torch_train.py): loss rtol 1e-5, each gradient
# leaf within 1e-4 of its largest |entry|
TRAIN_ARCH = "smollm_360m"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 3
RESTART_BATCH, RESTART_SEQ = 8, 256
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
# data-parallel training (phase 15): phase 14's runs through a one-rank
# NCCL mesh; a collective that waits longer than this fails; the
# compressed all-reduce on a gradient of smollm's embedding's shape
DP_TIMEOUT_S = 300.0
PSUM_SHAPE = (49152, 960)
# tensor-parallel training (phase 16): four ranks share the one card and
# talk over gloo, a rehearsal of the exchanges; (a) smollm-360m at full
# width and depth, train_4k cut to 4 sequences of 1024 tokens (two rows a
# replica on (2, 2)); (b) mamba2-370m at its published size and (c)
# phi3-mini-3.8b at its published width with its depth cut 32 -> 2
# layers, on (1, 4); step 0's loss within 2^-8 and the gathered gradient's
# cosine with the mesh-less one at least 0.999 (bf16 products summed in
# other orders); (d) every family's .reduced() in f32 on (2, 2) at the CPU
# tests' bounds (tests/test_torch_tp.py), a (2, 2) checkpoint restored on
# (1, 4) to rtol 1e-4
TP_RANKS = 4
TP_BATCH, TP_SEQ, TP_STEPS = 4, 1024, 2
TP_FULL = (("smollm_360m", None, ((2, 2), (1, 4))),
           ("mamba2_370m", None, ((1, 4),)),
           ("phi3_mini_3_8b", 2, ((1, 4),)))
TP_LOSS_REL, TP_COSINE = 2.0 ** -8, 0.999
TP_REDUCED = ("smollm_360m", "phi3_5_moe_42b", "mamba2_370m",
              "jamba_1_5_large_398b", "seamless_m4t_large_v2")
TP_REDUCED_BATCH, TP_REDUCED_SEQ, TP_REDUCED_STEPS = 4, 32, 3
TP_STEP0_REL, TP_LATER_REL, TP_RESTORE_RTOL = 1e-5, 1e-3, 1e-4
TP_JOIN_S = 900.0
# sharded serving (phase 18), four ranks on the one card over gloo: (arch,
# mesh, batch, prompt, new tokens) at the published sizes, bf16, each
# prefill's last logits and each decode step's within SERVE_BF16_STEPS bf16
# steps of the largest |logit| of the mesh-less step's (absolute; a step
# is 2^-8 to 2^-7 of that logit).  The sharded GEMMs sum in other orders
# than the whole ones, and 32-48 layers of bf16 activations carry the
# rounding: the most read on the card was 2.75 steps (mamba2-370m decode,
# 48 layers).  The mesh-less step's own spread under a change of
# summation order alone is printed beside it (serve_tp_floors).  The
# reduced configs (arch, kv_quant) in f32 on (2, 2) at
# tests/test_torch_serve_tp.py's bounds, (batch, prompt, new tokens,
# encoder frames) SERVE_TP_SMALL
SERVE_TP_FULL = (("phi3_mini_3_8b", (1, 4), 4, 1024, 16),
                 ("smollm_360m", (2, 2), 4, 512, 8),
                 ("mamba2_370m", (1, 4), 4, 512, 8))
SERVE_TP_REDUCED = (("smollm_360m", False), ("smollm_360m", True),
                    ("phi3_5_moe_42b", False), ("mamba2_370m", False),
                    ("jamba_1_5_large_398b", False),
                    ("jamba_1_5_large_398b", True),
                    ("seamless_m4t_large_v2", False),
                    ("seamless_m4t_large_v2", True))
SERVE_TP_SMALL = (4, 16, 4, 8)
SERVE_PREFILL_REL, SERVE_DECODE_REL = 1e-5, 1e-3
SERVE_BF16_STEPS = 4
SERVE_FLASH_REPS = 50
# the architectures whose (2, 16, 16) train_4k cell phase 17 runs (every
# (16, 16) cell runs): the others' were cut for the script's time limit
# when phase 19 came (they took 524 s of the host's cores in PR 27 run
# 8); tests/test_torch_dryrun_cells.py and _pods.py trace them on the CPU
DRYRUN_MULTI_ARCHS = ("smollm_360m",)
# the reference's examples as the port's entry points (phase 19): each
# examples/torch_*.py's main() in this process at the reference's default
# sizes (the LM example's checkpoints under a temporary directory), the
# serving example twice, the second answering from the autotuner's cache
EXAMPLES = ("torch_quickstart", "torch_serve_forest", "torch_ranking_e2e",
            "torch_train_lm", "torch_elastic_restart")
# the dry run (phase 17): every production training cell, one process a
# (arch, mesh) on the host's cores, the longest traces first (on one
# CPU core: jamba 248 s, mamba2 93 s, command-r 68 s, grok 48 s, the rest
# 7-24 s a cell); phase 14's cell traced on a one-rank fake world, its
# arguments plus temporaries within this band of phase 14's measured peak
DRYRUN_ARCHS = ("jamba_1_5_large_398b", "mamba2_370m",
                "command_r_plus_104b", "grok_1_314b", "chameleon_34b",
                "seamless_m4t_large_v2", "phi3_mini_3_8b", "phi3_5_moe_42b",
                "smollm_360m", "starcoder2_3b")
DRYRUN_PEAK_BAND = (0.75, 1.25)
# the serving cells phase 17 runs, on the (16, 16) mesh only (the
# (2, 16, 16) mesh's would double the phase's time), in processes after
# each architecture's training cells; the decode and long-context cells
# also with --kv-quant
DRYRUN_SERVE_SHAPES = ("prefill_32k", "decode_32k", "long_500k")
DRYRUN_TIMEOUT_S = 600.0
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
    sync(device)
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


def edge_rows(forest, X, seed=0):
    """``X`` as float64 with values that try the input transform: whole
    NaN rows, scattered NaN, ±inf and -0.0, each feature's ``lo`` and
    ``hi``, and one ulp either side of grid edges."""
    X = np.array(X, dtype=np.float64)
    n, d = X.shape
    rng = np.random.default_rng(seed)
    cols = np.arange(d) if forest.feat_map is None else \
        np.asarray(forest.feat_map)
    lo, hi = forest.feat_lo, forest.feat_hi
    for value, start in ((np.nan, 1), (np.inf, 2), (-np.inf, 3), (-0.0, 4)):
        X[start::11, rng.integers(0, X.shape[1], size=3)] = value
    X[5::13, cols] = lo
    X[6::17, cols] = hi
    k = rng.integers(0, int(forest.quant_scale) + 1, size=len(cols))
    edge = lo + k * (hi - lo) / forest.quant_scale
    X[7::19, cols] = np.nextafter(edge, -np.inf)
    X[8::23, cols] = np.nextafter(edge, np.inf)
    X[::29] = np.nan
    return X


def compare_quantize(forest, X, rows: int, device) -> int:
    """``quantize_rows`` on ``device`` for rows ``X`` into a bucket of
    ``rows``, from f32 and from f64 callers: bit for bit its plain torch
    version on the same tensors and the host's ``quantize_inputs(forest,
    X).astype(float32)``, rows past ``len(X)`` +0.0.  Returns the kernel's
    launches (two on the card, none on the CPU)."""
    grid = ops.InputGrid(forest, device)
    before = quantize_rows.launches
    for dtype in (np.float32, np.float64):
        Xd = np.ascontiguousarray(X, dtype=dtype)
        x = torch.from_numpy(Xd).to(device)
        args = (x, grid.lo, grid.span, grid.cols)
        kw = dict(scale=grid.scale, bits=grid.bits,
                  nan_value=grid.nan_value, rows=rows)
        got = quantize_rows(*args, **kw).cpu().numpy()
        ref = quantize_rows_reference(*args, **kw).cpu().numpy()
        want = np.zeros_like(got)
        with np.errstate(invalid="ignore"):
            want[:len(X)] = core.quantize_inputs(forest, Xd).astype(
                np.float32)
        what = (f"quantize_rows {np.dtype(dtype).name} rows {Xd.shape} "
                f"into {rows}, int{grid.bits}")
        if not np.array_equal(got.view(np.uint32), ref.view(np.uint32)):
            raise AssertionError(f"{what}: kernel != plain version")
        if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
            raise AssertionError(f"{what}: kernel != host quantize_inputs")
    return quantize_rows.launches - before


def pixel_edge_rows(forest, X, seed=0):
    """``X``, 8-bit pixel rows, with values that try the input transform
    at 8 bits: whole rows of 0 and of 255, each feature's ``lo`` and
    ``hi``, and the pixel values either side of grid edges."""
    X = np.array(X, dtype=np.uint8)
    rng = np.random.default_rng(seed)
    lo, hi = forest.feat_lo, forest.feat_hi
    X[1::11] = 0
    X[2::13] = 255
    X[5::17] = np.clip(np.round(lo), 0, 255)
    X[6::19] = np.clip(np.round(hi), 0, 255)
    k = rng.integers(0, int(forest.quant_scale) + 1, size=len(lo))
    edge = lo + k * (hi - lo) / forest.quant_scale
    X[7::23] = np.clip(np.floor(edge), 0, 255)
    X[8::29] = np.clip(np.ceil(edge), 0, 255)
    return X


def compare_pixel_feed(forest, X, rows: int, device) -> int:
    """``InputGrid.feed`` of 8-bit rows ``X`` as a caller sends them
    (widened to float64 on the host, then ``quantize_rows``) into a
    bucket of ``rows``: bit for bit the plain version on the widened rows
    and the host's ``quantize_inputs(forest, X).astype(float32)``, rows
    past ``len(X)`` +0.0.  Returns the kernel's launches (one on the
    card, none on the CPU)."""
    grid = ops.InputGrid(forest, device)
    before = quantize_rows.launches
    got = grid.feed(X, rows).x.cpu().numpy()
    launches = quantize_rows.launches - before
    x = torch.from_numpy(X.astype(np.float64)).to(device)
    ref = quantize_rows_reference(
        x, grid.lo, grid.span, grid.cols, scale=grid.scale, bits=grid.bits,
        nan_value=grid.nan_value, rows=rows).cpu().numpy()
    want = np.zeros_like(got)
    want[:len(X)] = core.quantize_inputs(forest, X).astype(np.float32)
    what = (f"InputGrid.feed uint8 rows {X.shape} into {rows}, "
            f"int{grid.bits}")
    if not np.array_equal(got.view(np.uint32), ref.view(np.uint32)):
        raise AssertionError(f"{what}: kernel != plain version")
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError(f"{what}: kernel != host quantize_inputs")
    return launches


def quantize_check(msn, full, qfull, device) -> dict:
    """Phase 3's input transform: ``compare_quantize`` at the cells' shapes
    (``QUANTIZE_MSN`` on the MSN int16 forest ``qfull``, the magic
    cascade's ``MAGIC_ROWS`` x 10), on the control's int8 grid and through
    a ``feat_map``, on ``edge_rows``, from f32 and f64 callers; and the
    mnist cascade's call, ``MNIST_ROWS`` x 784 8-bit rows on
    ``pixel_edge_rows`` through ``InputGrid.feed`` into an int16 grid
    fitted to 8-bit rows.  One launch per shape and dtype on the card.
    Returns the rows and the magic forest phase 12 times, the number of
    shapes and the launches."""
    d = qfull.n_features
    msn_rows = np.resize(np.concatenate([msn.X_test, msn.X_train]),
                         (QUANTIZE_MSN[0][0], d))
    magic = datasets.make_magic()
    magic_rows = np.resize(np.concatenate([magic.X_train, magic.X_test]),
                           (MAGIC_ROWS, magic.X_train.shape[1]))
    mforest = core.quantize_forest(
        core.random_forest_ir(64, 64, magic_rows.shape[1], seed=1),
        magic.X_train, QUANT)
    qfull8 = core.quantize_forest(full, msn.X_train, QUANT8)
    wide = np.random.default_rng(1).permutation(d + 14)[:d]
    mapped = dataclasses.replace(qfull, feat_map=wide,
                                 n_features_src=d + 14)
    msn_wide = np.full((len(msn_rows), d + 14), 7.0)
    msn_wide[:, wide] = msn_rows
    cases = [(qfull, msn_rows[:n], b) for n, b in QUANTIZE_MSN] + [
        (mforest, magic_rows, MAGIC_ROWS),
        (qfull8, msn_rows, len(msn_rows)), (qfull8, msn_rows[:100], 128),
        (mapped, msn_wide[:1024], 1024)]
    n = sum(compare_quantize(f, edge_rows(f, X), b, device)
            for f, X, b in cases)
    mnist = datasets.make_mnist()
    pixels = np.resize(np.round(255 * np.concatenate(
        [mnist.X_train, mnist.X_test])).astype(np.uint8),
        (MNIST_ROWS, mnist.X_train.shape[1]))
    pforest = core.quantize_forest(
        core.random_forest_ir(64, 64, pixels.shape[1], n_classes=10,
                              seed=2), pixels[:len(mnist.X_train)], QUANT)
    n += compare_pixel_feed(pforest, pixel_edge_rows(pforest, pixels),
                            MNIST_ROWS, device)
    if n != (2 * len(cases) + 1 if device.type == "cuda" else 0):
        raise AssertionError(f"quantize_rows launched {n} times for "
                             f"{len(cases)} shapes x 2 dtypes and the "
                             "8-bit feed")
    return dict(msn_rows=msn_rows, magic_rows=magic_rows, mforest=mforest,
                n_cases=len(cases) + 1, launches=n)


def quantize_timing(forest, X, device) -> dict:
    """``quantize_rows`` on rows ``X`` (f32, as the benchmark's cells send
    them) into a bucket of ``len(X)``: eager ms, device ms by graph
    replay, the plain version's ms, and the bound by bytes (the rows read,
    the feed written, the grid's arrays read once)."""
    grid = ops.InputGrid(forest, device)
    x = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float32)).to(
        device)
    kw = dict(scale=grid.scale, bits=grid.bits, nan_value=grid.nan_value,
              rows=len(X))
    args = (x, grid.lo, grid.span, grid.cols)
    ms = cuda_ms(lambda: quantize_rows(*args, **kw), 200)
    device_ms = graph_ms(lambda: quantize_rows(*args, **kw), 200)
    plain_ms = cuda_ms(lambda: quantize_rows_reference(*args, **kw), 10)
    nbytes = sum(t.numel() * t.element_size() for t in args
                 if t is not None) + len(X) * len(forest.feat_lo) * 4
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                nbytes=nbytes, shape=list(X.shape))


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
    quantize_rows.launches = 0
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


def transform_launches() -> int:
    """``quantize_rows``' launches.  Apart from ``launch_counts``, whose
    callers compare it with the forest and attention kernels they expect:
    the input transform launches beside the forest kernels of every
    quantized predictor on the card."""
    return quantize_rows.launches


def main_path(forest, X_calib, rows, device, engine="bitvector"):
    """Quantize → compile_forest(engine, backend="cuda") → serve.  Every
    kernel's launch count is set to 0 just before and read just after;
    the engine's kernel and ``quantize_rows`` must each have launched once
    per served batch and the others not at all.  Returns (predictor,
    served output, server, the engine's launches)."""
    reset_launches()
    qforest = core.quantize_forest(forest, X_calib, QUANT)
    pred = core.compile_forest(qforest, engine=engine, backend="cuda",
                               device=device)
    served, server = serve(pred, rows)
    counts = launch_counts()
    transforms = transform_launches()
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
    want = server.stats.n_batches if device.type == "cuda" else 0
    if transforms != want:
        raise AssertionError(f"{engine}: quantize_rows launched "
                             f"{transforms} times for "
                             f"{server.stats.n_batches} batches")
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
    sync(device)
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
        transforms = transform_launches()
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
        # the fused tiers quantize on the card, the staged loop on the host
        want = server.stats.n_batches if on_card and name != "staged" \
            else 0
        if transforms != want:
            raise AssertionError(f"{name} cascade: quantize_rows launched "
                                 f"{transforms} times, expected {want}")
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
                          launches=counts, routes=cascade_routes,
                          transforms=transforms)
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
        served=f["served"], full=full,
        stages=fused.stages, launches=f["launches"]["cascade"],
        routes=f["routes"],
        transform_launches={name: r["transforms"]
                            for name, r in runs.items()},
        staged_launches=st["launches"]["bitvector"],
        tier1_launches={e: runs[f"fused_{e}"]["launches"][e]
                        for e in CASCADE_TIER1_ENGINES},
        n_batches=f["server"].stats.n_batches,
        exit_counts=[int(c) for c in exits],
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


def host_split(pred, X, reps: int = 20) -> dict:
    """Host milliseconds (median of ``reps``) of each span of one served
    fused batch (``repro_torch.obs.trace``: transform, pad, h2d, launch,
    d2h, the last holding the wait for the card) and its bucket, after a
    first call that builds what the predictor builds on first use.  The
    root's children by name; a child's own children as
    ``<child>.<name>`` (``transform.h2d`` where the card quantizes the
    rows), which the children's times already hold."""
    pred.predict(X)
    trace.enable(True)
    trace.drain()
    try:
        for _ in range(reps):
            pred.predict(X)
    finally:
        trace.enable(False)
    spans = trace.drain()
    names = {s["id"]: s["name"].removeprefix("repro_torch.") for s in spans}
    roots = {s["id"] for s in spans if s["parent"] is None}
    kids = {s["id"] for s in spans if s["parent"] in roots}
    ms, bucket = defaultdict(list), None
    for s in spans:
        if s["parent"] in roots:
            name = names[s["id"]]
        elif s["parent"] in kids:
            name = f"{names[s['parent']]}.{names[s['id']]}"
        else:
            continue
        ms[name].append((s["end_ns"] - s["start_ns"]) / 1e6)
        bucket = s.get("padded_rows", bucket)
    return {k: float(np.median(v)) for k, v in ms.items()} | {
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
        sync(device)
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


def check_tuned_launches(choice, counts: dict, what: str, device) -> None:
    """On the card every ``cuda-*`` candidate the sweep timed launched its
    kernel, and no kernel outside the sweep's candidates launched."""
    timed = {TUNE_KERNELS[c.split("@")[0]] for c in choice.timings
             if c.split("@")[0] in TUNE_KERNELS}
    fused = any(c.startswith("cuda-qs@cascade-fused") for c in choice.timings)
    for engine, n in counts.items():
        want = device.type == "cuda" and (engine in timed or (
            engine == "cascade" and fused))
        if bool(n) != want:
            raise AssertionError(f"{what}: {engine} launched {n} times")


def tuned_engine(pred) -> tuple:
    """What a predictor compiles: (engine, backend, opt, cascade tag)."""
    plan = pred.plan
    return (plan.engine, plan.backend, plan.opt,
            plan.cascade.tag() if plan.cascade is not None else None)


def autotune_sweep(qforest, rows, device, cache, batch=MAX_BATCH) -> dict:
    """Phase 7 step 1: ``choose`` over the nine engines as-is and at -O2
    (18 candidates, one optimize pass through the shared IR), every launch
    count at 0 just before and read just after; the winner's output on
    ``rows`` must equal plain torch bit for bit."""
    engines = engine_select.default_engines(True, device)
    reset_launches()
    t0 = time.perf_counter()
    choice = engine_select.choose(qforest, batch, device=device,
                                  engines=engines, opt_levels=AUTOTUNE_OPT,
                                  cache_path=cache)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    check_tuned_launches(choice, counts, "autotune sweep", device)
    if len(choice.timings) != 2 * len(engines) or choice.from_cache:
        raise AssertionError(f"autotune sweep: {sorted(choice.timings)}, "
                             f"from_cache {choice.from_cache}")
    plain = core.compile_forest(qforest, engine="bitvector", backend="torch",
                                device=device).predict(rows)
    if not np.array_equal(choice.predict(rows), plain):
        raise AssertionError(f"autotune winner {choice.engine} != plain "
                             "torch")
    return dict(choice=choice, launches=counts, wall=wall)


def autotune_second_process(qforest, device, cache, tmpdir,
                            batch=MAX_BATCH) -> dict:
    """Phase 7 step 2: a second process loads the forest from its file
    and asks the same question of the same cache file; returns what it
    reports (``from_cache``, ``engine``, ``sweeps``)."""
    path = os.path.join(tmpdir, "tune.repro.npz")
    io.save_forest(qforest, path)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    out = subprocess.run(
        [sys.executable, "-c", CACHE_HIT_CHILD, src, path, cache,
         str(batch), device.type], capture_output=True, text=True,
        check=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


def autotune_server(qforest, rows, served, device, cache,
                    batch=MAX_BATCH) -> dict:
    """Phase 7 step 3: ``ForestServer.from_forest`` answers from the cache
    and serves ``rows`` (all at once: ``len(rows) / batch`` batches), bit
    for bit ``served``; a kernel winner launches once per batch, and
    nothing else launches.  Then ``compile_forest(tune="measure")`` builds
    the same engine from the cache, with no sweep."""
    sweeps = get_registry().get("repro_autotune_sweeps_total")
    n_sweeps = sweeps.value
    srv = ForestServer.from_forest(qforest, max_batch=batch, device=device,
                                   cache_path=cache)
    if not srv.engine_choice.from_cache:
        raise AssertionError("from_forest swept again")
    reset_launches()
    for row in rows:
        srv.submit(row, arrival_s=0.0)
    done = srv.flush(now_s=1.0)
    counts = launch_counts()
    out = np.stack([r.result for r in done])
    if not np.array_equal(out, served):
        raise AssertionError("from_forest served another output than "
                             "phase 4")
    n_batches = srv.stats.n_batches
    engine = TUNE_KERNELS.get(srv.engine_choice.engine.split("@")[0])
    want = {k: (n_batches if k == engine and device.type == "cuda" else 0)
            for k in counts}
    if counts != want:
        raise AssertionError(f"from_forest: launches {counts}, expected "
                             f"{want}")
    pred = core.compile_forest(qforest, tune="measure", tune_batch=batch,
                               device=device, cache_path=cache)
    if tuned_engine(pred) != tuned_engine(srv.predictor) or \
            sweeps.value != n_sweeps:
        raise AssertionError(f"compile_forest(tune=) built "
                             f"{tuned_engine(pred)}, from_forest "
                             f"{tuned_engine(srv.predictor)}")
    return dict(server=srv, launches=counts, n_batches=n_batches)


def autotune_cascade(qforest, stages, policy, rows, fused_served, full,
                     device, cache, batch=MAX_BATCH) -> dict:
    """Phase 7 step 4: ``choose`` over cuda-qs and qs, each as-is, staged
    and fused with the calibrated gate (the fused cuda-qs candidate
    launches ``cascade_qs_forward``, the staged one ``qs_forward``); the
    winner serves ``rows`` bit for bit as phase 5 did: a cascade winner
    ``fused_served``, a plain one the whole forest's ``full``."""
    specs = (CascadeSpec(stages, policy), CascadeSpec(stages, policy,
                                                      fused=True))
    reset_launches()
    choice = engine_select.choose(qforest, batch, device=device,
                                  engines=CASCADE_TUNE_ENGINES,
                                  cascade_specs=specs, cache_path=cache)
    counts = launch_counts()
    check_tuned_launches(choice, counts, "cascade sweep", device)
    reset_launches()
    out, _ = serve(choice.predictor, rows, max_batch=batch)
    served_launches = launch_counts()
    want = fused_served if "@cascade" in choice.engine else full
    if not np.array_equal(out, want):
        raise AssertionError(f"cascade autotune winner {choice.engine} "
                             "serves other scores than phase 5")
    # the gate decides what a cascade candidate costs: its exits on the
    # sweep's rows (N(0, 1), as choose times them) against the served rows
    fused = core.compile_forest(qforest, engine="bitvector", backend="cuda",
                                device=device, cascade=specs[1])
    exits = {}
    for name, X in (("sweep", engine_select._bench_rows(
            qforest, bucket_batch(batch), 0)), ("served", rows)):
        fused.reset_exit_stats()
        fused.predict(X)
        exits[name] = fused.exit_fractions
    return dict(choice=choice, launches=counts,
                served_launches=served_launches, exits=exits)


def ladder_forest(T, L, d, C, seed):
    """A random int16 int-accum forest of the -Os ladder."""
    forest = core.random_forest_ir(T, L, d, n_classes=C, seed=seed)
    X = np.random.default_rng(seed).normal(size=(512, d))
    return core.quantize_forest(forest, X, QUANT)


def autotune_predict(device, cache, model_path, ladder=PREDICT_LADDER,
                     held_out=PREDICT_HELD_OUT, batch=PREDICT_BATCH) -> dict:
    """Phase 7 step 5: measured sweeps over the ladder, ``train_from_cache``
    of the whole cache, then ``choose(mode="predict")`` on each held-out
    shape (thresholds ``PREDICT_THRESHOLDS``), whose winner must equal
    plain torch bit for bit, and of whose candidates (the predicted one,
    or the top-k of a fallback) exactly the kernels launched.  Returns
    the ladder's choices, the model and per held-out shape (choice,
    relative error read from ``repro_autotune_predict_last_rel_error``)."""
    sweeps = []
    for i, (T, L, d, C) in enumerate(ladder):
        f = ladder_forest(T, L, d, C, seed=100 + i)
        sweeps.append(((T, L, d, C), engine_select.choose(
            f, batch, device=device, engines=PREDICT_ENGINES,
            cache_path=cache)))
    model = tune.train_from_cache(cache, save_to=model_path)
    asked = []
    for i, ((T, L, d, C), thr) in enumerate(zip(held_out,
                                                PREDICT_THRESHOLDS)):
        f = ladder_forest(T, L, d, C, seed=200 + i)
        reset_launches()
        choice = engine_select.choose(
            f, batch, device=device, engines=PREDICT_ENGINES, mode="-Os",
            cost_model=model_path, confidence_threshold=thr,
            cache_path=cache)
        check_tuned_launches(choice, launch_counts(), "-Os", device)
        X = np.random.default_rng(i).normal(size=(batch, d))
        plain = core.compile_forest(f, engine="bitvector", backend="torch",
                                    device=device).predict(X)
        if not np.array_equal(choice.predict(X), plain):
            raise AssertionError(f"-Os winner {choice.engine} at "
                                 f"{(T, L, d, C)} != plain torch")
        rel = None
        if choice.predicted:
            rel = get_registry().get(
                "repro_autotune_predict_last_rel_error").labels(
                    key=choice.key).value
        asked.append(((T, L, d, C), thr, choice, rel))
    if not asked[-1][2].predicted:
        raise AssertionError("-Os at threshold 0 did not predict")
    return dict(sweeps=sweeps, model=model, asked=asked)


def fleet_traffic(n_msn: int, n_mnist: int, rate_hz: float, seed=0):
    """Open-loop arrivals for the fleet: ``n_msn`` MSN rows spread over the
    three MSN tenants in turn and ``n_mnist`` mnist requests, interleaved
    in a seeded order at seeded Poisson times (seconds from the start).
    Returns [(tenant, row index, arrival)]."""
    rng = np.random.default_rng(seed)
    kinds = rng.permutation(np.r_[np.zeros(n_msn, int), np.ones(n_mnist,
                                                                 int)])
    arrivals = np.cumsum(rng.exponential(1.0 / rate_hz, size=len(kinds)))
    names, out, seen = list(MSN_TENANTS), [], [0, 0]
    for kind, at in zip(kinds, arrivals):
        i = seen[kind]
        seen[kind] += 1
        out.append((names[i % 3] if kind == 0 else MNIST_TENANT, i,
                    float(at)))
    return out


def scrape_counters(text: str, name: str) -> dict:
    """``name{tenant="t"} v`` samples of a Prometheus scrape, by tenant."""
    pat = re.compile(rf'^{name}\{{tenant="([^"]+)"\}} (\S+)$', re.M)
    return {t: float(v) for t, v in pat.findall(text)}


def run_fleet(rt, traffic, msn_rows, mnist_rows, url=None) -> dict:
    """Drive ``traffic`` through the threaded runtime on the real clock,
    each request submitted at its arrival time, while a second thread
    scrapes ``/metrics`` and ``/traces`` from ``url`` (when given).  Every
    ``wait`` has a timeout.  Returns the requests, the wall time from the
    first arrival to the last answer, each scrape's ms (host clock, both
    endpoints) and the last scrape."""
    stop, scrapes, errors = threading.Event(), [], []

    def scraper():
        while not stop.is_set():
            try:
                t0 = time.perf_counter()
                for path in ("/metrics", "/traces?n=16"):
                    with urllib.request.urlopen(url + path,
                                                timeout=10) as resp:
                        resp.read()
                scrapes.append((time.perf_counter() - t0) * 1e3)
            except Exception as e:              # noqa: BLE001 — reported
                errors.append(repr(e))
            stop.wait(5e-3)

    th = threading.Thread(target=scraper, daemon=True) if url else None
    reqs = []
    with rt:
        if th is not None:
            th.start()
        base = time.perf_counter() + 0.005
        for tenant, i, at in traffic:
            target = base + at
            while time.perf_counter() < target:
                time.sleep(min(max(target - time.perf_counter(), 0.0),
                               5e-4))
            row = mnist_rows[i] if tenant == MNIST_TENANT else msn_rows[i]
            reqs.append((tenant, i, rt.submit(tenant, row,
                                              arrival_s=target)))
        for _, _, r in reqs:
            r.wait(timeout=RUNTIME_TIMEOUT_S)
        wall = max(r.done_s for _, _, r in reqs) - base
        last = None
        if th is not None:
            stop.set()
            th.join(timeout=30)
            if th.is_alive() or errors or not scrapes:
                raise AssertionError(f"scrape thread: {len(scrapes)} "
                                     f"scrapes, errors {errors[:3]}")
            with urllib.request.urlopen(url + "/metrics",
                                        timeout=10) as resp:
                last = resp.read().decode()
    return dict(reqs=reqs, wall=wall, scrapes=scrapes, last=last)


def runtime_fleet(msn_preds, fused, msn_rows, msn_served, mnist_rows,
                  mnist_exits, device, max_batch=MAX_BATCH,
                  rate_hz=RUNTIME_RATE_HZ) -> dict:
    """Phase 9 step 1: four tenants in one ``ServingRuntime``: the MSN
    forest on each kernel engine (``msn_preds``, by engine) and the fused
    mnist cascade.  A first, unthrottled run gives ``msn-qs`` its p99;
    the served run gives ``msn-qs`` that p99 as its ``SLOConfig`` target.
    Each run is warmed over ``bucket_ladder(max_batch)`` and serves the
    same open-loop traffic with a scrape thread beside it.  Every launch
    count is set to 0 just before the served run's traffic and read just
    after.  Checks: served == each tenant's synchronous ``predict`` and ==
    ``msn_served`` (MSN rows) bit for bit; the cascade's exit counts ==
    ``mnist_exits``; each kernel launched once per batch of its tenant, on
    the x-tile route, and no other kernel; no first use after warmup; the
    scrape lists the whole catalog with the request and batch counters of
    ``stats()``; every request answered once."""
    on_card = device.type == "cuda"
    preds = {t: msn_preds[e] for t, e in MSN_TENANTS.items()}
    preds[MNIST_TENANT] = fused
    traffic = fleet_traffic(len(msn_rows), len(mnist_rows), rate_hz)

    def fleet(slo_p99=None):
        rt = ServingRuntime(obs=MetricsRegistry())
        for tid, pred in preds.items():
            slo = SLOConfig(target_p99_ms=slo_p99) \
                if slo_p99 is not None and tid == SLO_TENANT else None
            rt.add_model(tid, pred, max_batch=max_batch,
                         max_wait_ms=RUNTIME_WAIT_MS, slo=slo)
        warmed = rt.warmup()
        if any(w != list(engine_select.bucket_ladder(max_batch))
               for w in warmed.values()):
            raise AssertionError(f"warmup covered {warmed}")
        return rt

    rt = fleet()
    free = run_fleet(rt, traffic, msn_rows, mnist_rows)
    free_phases, free_first = phase_means(rt), compute_first_max(rt)
    target = rt.summary(SLO_TENANT)["p99_ms"]
    rt = fleet(target)
    url = rt.serve_metrics(port=0).url
    reset_launches()
    run = run_fleet(rt, traffic, msn_rows, mnist_rows, url)
    counts, routes = launch_counts(), tile_routes()
    transforms = transform_launches()
    cascade_routes = dict(cascade_qs_forward.launches_by_route)
    stats = rt.stats()
    summary = {tid: rt.summary(tid) for tid in rt.model_ids}
    reg = rt.obs.registry

    # every request answered once, by the tenant it was sent to
    reqs = run["reqs"]
    if len({r.rid for *_, r in reqs}) != len(traffic) or any(
            r.result is None or not r.future.done() for *_, r in reqs):
        raise AssertionError("a request was dropped or answered twice")
    if sum(s["n_requests"] for s in stats.values()) != len(traffic) or \
            reg.get("repro_request_errors_total").samples():
        raise AssertionError(f"requests by tenant "
                             f"{ {t: s['n_requests'] for t, s in stats.items()} }"
                             f" for {len(traffic)} sent, or errors")
    for tid, s in stats.items():
        if s["compile_events"] or s["retrace_anomalies"]:
            raise AssertionError(f"{tid}: {s['compile_events']} first uses "
                                 f"and {s['retrace_anomalies']} anomalies "
                                 "after warmup")
    want = {k: 0 for k in counts}
    for tid, engine in MSN_TENANTS.items():
        want[engine] = stats[tid]["n_batches"] if on_card else 0
    want["cascade"] = stats[MNIST_TENANT]["n_batches"] if on_card else 0
    if counts != want:
        raise AssertionError(f"fleet launches {counts}, expected {want}")
    check_routes(routes, counts, "fleet")
    if cascade_routes != {"smem_x": counts["cascade"], "global_x": 0}:
        raise AssertionError(f"fleet cascade routes {cascade_routes}")
    exits = stats[MNIST_TENANT]["exit_fractions"]
    got_exits = [int(c) for c in
                 rt.tenant(MNIST_TENANT).stats.stage_exit_counts]
    if got_exits != [int(c) for c in mnist_exits]:
        raise AssertionError(f"fleet cascade exits {got_exits}, phase 5 "
                             f"{list(mnist_exits)}")

    # the scrape: the whole catalog, and the counters stats() reports
    text = run["last"]
    missing = [n for n in METRIC_CATALOG if f"# TYPE {n} " not in text]
    scraped_req = scrape_counters(text, "repro_requests_total")
    scraped_bat = scrape_counters(text, "repro_batches_total")
    if missing or any(scraped_req.get(t) != s["n_requests"] or
                      scraped_bat.get(t) != s["n_batches"]
                      for t, s in stats.items()):
        raise AssertionError(f"scrape: missing {missing}, requests "
                             f"{scraped_req}, batches {scraped_bat}")

    # served == synchronous predict == phase 4 / phase 5 input, bit for bit
    served = {tid: [] for tid in preds}
    for tid, i, r in reqs:
        served[tid].append((i, r.result))
    for tid, pairs in served.items():
        idx = np.array([i for i, _ in pairs])
        got = np.stack([s for _, s in pairs])
        src = mnist_rows if tid == MNIST_TENANT else msn_rows
        direct = np.concatenate([preds[tid].predict(src[idx[j:j + max_batch]])
                                 for j in range(0, len(idx), max_batch)])
        if not np.array_equal(got, direct):
            raise AssertionError(f"{tid}: served != synchronous predict")
        if tid != MNIST_TENANT and not np.array_equal(got,
                                                      msn_served[idx]):
            raise AssertionError(f"{tid}: served != phase 4")
        if not np.isfinite(got).all():
            raise AssertionError(f"{tid}: non-finite scores")

    return dict(summary=summary, free=latency_percentiles(free),
                free_phases=free_phases, free_wall=free["wall"],
                deciles=(latency_deciles(free), latency_deciles(run)),
                first=(free_first, compute_first_max(rt)),
                target=target, phases=phase_means(rt), launches=counts,
                transform_launches=transforms, wall=run["wall"],
                scrapes=run["scrapes"],
                n_requests=len(traffic), exits=exits,
                n_series=sum(1 for ln in text.splitlines()
                             if ln and not ln.startswith("#")))


def phase_means(rt) -> dict:
    """Mean ms of each ``PHASES`` phase per tenant, from the runtime's
    ``repro_phase_ms`` histograms."""
    fam = rt.obs.registry.get("repro_phase_ms")
    out = {}
    for tid in rt.model_ids:
        out[tid] = {}
        for p in PHASES:
            h = fam.labels(tenant=tid, phase=p)
            out[tid][p] = h.sum / h.count if h.count else 0.0
    return out


def latency_deciles(run: dict) -> list:
    """p99 latency (ms) of each tenth of a ``run_fleet`` run's requests in
    arrival order: where in the run the tail sits."""
    lat = [r.latency_ms for *_, r in run["reqs"]]
    return [float(np.percentile(part, 99))
            for part in np.array_split(np.asarray(lat), 10)]


def compute_first_max(rt) -> dict:
    """Per tenant (first batch's, largest) ``compute_ms``, host clock."""
    out = {}
    for tid in rt.model_ids:
        ms = list(rt.tenant(tid).stats.compute_ms)
        out[tid] = (ms[0], max(ms))
    return out


def latency_percentiles(run: dict) -> dict:
    """p50 / p99 latency by tenant of one ``run_fleet`` run."""
    lat = {}
    for tid, _, r in run["reqs"]:
        lat.setdefault(tid, []).append(r.latency_ms)
    return {tid: (float(np.percentile(v, 50)), float(np.percentile(v, 99)))
            for tid, v in lat.items()}


def runtime_from_forests(qforest, rows, served, device, cache,
                         max_batch=MAX_BATCH) -> dict:
    """Phase 9 step 2: ``ServingRuntime.from_forests`` on the MSN forest
    with phase 7's cache file and engine list answers from the cache (no
    sweep) and serves ``rows`` bit for bit ``served``."""
    old = set_default_registry(MetricsRegistry())
    try:
        rt = ServingRuntime.from_forests(
            {"msn": qforest}, max_batch=max_batch, device=device,
            obs=MetricsRegistry(), cache_path=cache,
            engines=engine_select.default_engines(True, device),
            opt_levels=AUTOTUNE_OPT)
        sweeps = get_registry().get("repro_autotune_sweeps_total")
        n_sweeps = sweeps.value if sweeps is not None else 0.0
    finally:
        set_default_registry(old)
    choice = rt.tenant("msn").engine_choice
    if not choice.from_cache or n_sweeps:
        raise AssertionError(f"from_forests swept: from_cache "
                             f"{choice.from_cache}, sweeps {n_sweeps}")
    reqs = [rt.submit("msn", row, arrival_s=0.0) for row in rows]
    rt.flush(now_s=1.0)
    out = np.stack([r.result for r in reqs])
    if not np.array_equal(out, served):
        raise AssertionError("from_forests served another output than "
                             "phase 4")
    return dict(engine=choice.engine, sweeps=n_sweeps,
                n_batches=rt.summary("msn")["n_batches"])


def runtime_round_trip(qforest, cforest, stages, policy, rows, crows,
                       msn_served, mnist_served, device, tmpdir) -> dict:
    """Phase 9 step 3: a fleet of torch-engine tenants (the MSN forest on
    ``SAVED_ENGINES`` and the mnist cascade, staged) saved and loaded onto
    ``device`` serves bit for bit what phases 4 and 5 served; saving a
    fleet with a ``cuda`` tenant raises ``ValueError``."""
    rt = ServingRuntime(obs=False)
    for engine in SAVED_ENGINES:
        rt.add_model(f"msn-{engine}", core.compile_forest(
            qforest, engine=engine, backend="torch", device=device),
            max_batch=MAX_BATCH)
    rt.add_model(MNIST_TENANT, core.compile_forest(
        cforest, engine="bitvector", backend="torch", device=device,
        cascade=CascadeSpec(stages, policy)), max_batch=MAX_BATCH)
    manifest = rt.save(os.path.join(tmpdir, "fleet"))
    t0 = time.perf_counter()
    loaded = ServingRuntime.load(manifest, device=device, obs=False)
    load_ms = (time.perf_counter() - t0) * 1e3
    n = MAX_BATCH
    for tid in loaded.model_ids:
        if loaded.tenant(tid).predictor.device != device:
            raise AssertionError(f"{tid} loaded on "
                                 f"{loaded.tenant(tid).predictor.device}")
        src, want = (crows, mnist_served) if tid == MNIST_TENANT \
            else (rows, msn_served)
        reqs = [loaded.submit(tid, row, arrival_s=0.0) for row in src[:n]]
        loaded.flush(now_s=1.0)
        if not np.array_equal(np.stack([r.result for r in reqs]),
                              want[:n]):
            raise AssertionError(f"loaded fleet: {tid} serves another "
                                 "output")
    bad = ServingRuntime(obs=False)
    bad.add_model("msn-cuda", core.compile_forest(
        qforest, engine="bitvector", backend="cuda", device=device))
    try:
        bad.save(os.path.join(tmpdir, "bad"))
    except ValueError as e:
        error = str(e)
    else:
        raise AssertionError("saving a cuda tenant did not raise")
    return dict(tenants=list(loaded.model_ids), load_ms=load_ms,
                bytes=sum(os.path.getsize(os.path.join(tmpdir, "fleet", f))
                          for f in os.listdir(os.path.join(tmpdir,
                                                           "fleet"))),
                cuda_error=error)


def launcher_modes(device, n_trees=LAUNCH_TREES) -> dict:
    """Phase 9 step 4: ``repro_torch.launch.serve`` once in each mode, in
    this process, at a small request count (its JSON output kept, not
    printed); each mode must launch its kernel on the card: ``qs_forward``
    for ``forest`` and ``runtime``, ``flash_forward`` for ``lm``."""
    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    common = ["--quantize", "--n-trees", str(n_trees)]
    modes = {
        "forest": ["--mode", "forest", "--n-requests", "300"] + common,
        "runtime": ["--mode", "runtime", "--tenants", "2",
                    "--n-requests", "400", "--rate", "2000",
                    "--slo-p99-ms", "20", "--metrics-port", "0"] + common,
        "lm": ["--mode", "lm", "--reduced", "--batch", "2",
               "--prompt-len", "16", "--n-new", "4"]}
    out = {}
    for mode, argv in modes.items():
        reset_launches()
        buf = StringIO()
        with contextlib.redirect_stdout(buf):
            res = serve_launcher.main(argv + dev)
        counts = launch_counts()
        kernel = "flash" if mode == "lm" else "bitvector"
        if device.type == "cuda" and (not counts[kernel] or any(
                n for k, n in counts.items() if k != kernel)):
            raise AssertionError(f"launcher {mode}: launches {counts}")
        if mode == "runtime" and any(s["retrace_anomalies"]
                                     for s in res["tenants"].values()):
            raise AssertionError(f"launcher runtime: {res['tenants']}")
        out[mode] = dict(result=res, launches=counts[kernel])
    return out


def flash_inputs(B, Sq, Sk, H, K, hd, dtype, device, seed=0):
    """Seeded head-major q (B*H, Sq, hd) and k/v (B*K, Sk, hd), made on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn(b * h, n, hd, generator=g, device=device)
                 .to(dtype) for b, h, n in ((B, H, Sq), (B, K, Sk),
                                            (B, K, Sk)))


def bf16_step(x: float) -> float:
    """The spacing of bf16 values at |x|: 2^-7 of the power of two at or
    under it."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def compare_flash(B, Sq, Sk, H, K, hd, causal, dtype, device,
                  steps=None, q_offset=0) -> float:
    """``flash_forward`` vs its plain version on the same inputs (q's
    first row at key position ``q_offset``), within the reference's
    tolerance for ``dtype`` (in bf16 with ``steps``: within that many bf16
    steps of the largest |out|, absolute); on the card two launches must
    give the same bits.  Returns the largest absolute difference."""
    q, k, v = flash_inputs(B, Sq, Sk, H, K, hd, dtype, device,
                           seed=Sq * 31 + Sk + hd + q_offset)
    kw = dict(causal=causal, n_rep=H // K, q_offset=q_offset)
    got = flash_forward(q, k, v, **kw)
    want = flash_forward_reference(q, k, v, **kw)
    again = flash_forward(q, k, v, **kw)
    sync(device)
    tol = FLASH_TOL_F32 if dtype == torch.float32 else FLASH_TOL_BF16
    rtol = tol
    if dtype == torch.bfloat16 and steps:
        tol, rtol = steps * bf16_step(float(want.float().abs().max())), 0.0
    err = float((got.float() - want.float()).abs().max())
    tag = (B, Sq, Sk, H, K, hd, causal, str(dtype), q_offset)
    if got.dtype != dtype or got.shape != q.shape:
        raise AssertionError(f"flash {tag}: out {got.dtype} {got.shape}")
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=tol):
        raise AssertionError(f"flash {tag}: kernel vs plain version max "
                             f"|diff| {err} > {tol}")
    if not torch.equal(got, again):
        raise AssertionError(f"flash {tag}: two launches differ")
    return err


def visible_pairs(Sq: int, Sk: int, causal: bool, q_offset: int = 0) -> int:
    """(q, k) pairs the mask leaves visible in one head: all, or for the
    top-left causal mask min(q + q_offset + 1, Sk) keys for query q."""
    if not causal:
        return Sq * Sk
    n = min(Sq, max(Sk - q_offset, 0))        # rows that miss some key
    return n * (q_offset + 1) + n * (n - 1) // 2 + (Sq - n) * Sk


def flash_bound(q, k, v, causal: bool, q_offset: int = 0):
    """Least time for the attention on these operands: 4*hd operations per
    visible (q, k) pair (q.k and p*v; the softmax's exps not counted) at
    the bf16 tensor rate, or q, k, v read and out written once at the HBM
    rate — the larger."""
    BH, Sq, hd = q.shape
    n_ops = 4 * hd * BH * visible_pairs(Sq, k.shape[1], causal, q_offset)
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, q))
    t_ops, t_bytes = n_ops / BF16_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("bytes" if t_bytes >= t_ops else "operations"), nbytes, n_ops


def library_attention(q4, k4, v4, causal: bool = True, q_offset: int = 0):
    """One ``scaled_dot_product_attention`` call computing
    ``flash_forward``'s function (causal or not, GQA) on the same inputs,
    on PyTorch's fused backends only (the math backend would hold the
    whole score matrix: 64 GB at S = 32768).  With ``enable_gqa`` where a
    fused backend takes it, else over k/v repeated to every query head.
    A causal chunk at ``q_offset`` attends over K/V cut to its last key,
    ``[:q_offset + Sq]``, under ``causal_lower_right``.  Returns (call,
    which form).  A yardstick: the port never calls it."""
    kw = dict(is_causal=causal)
    if causal and q_offset:
        from torch.nn.attention.bias import causal_lower_right
        Sq, Sk = q4.shape[2], q_offset + q4.shape[2]
        k4, v4 = k4[:, :, :Sk], v4[:, :, :Sk]
        kw = dict(attn_mask=causal_lower_right(Sq, Sk))

    def gqa():
        return F.scaled_dot_product_attention(q4, k4, v4, enable_gqa=True,
                                              **kw)
    with sdpa_kernel(FUSED_SDPA):
        try:
            gqa()
            return gqa, "enable_gqa"
        except RuntimeError:
            pass
    rep = q4.shape[1] // k4.shape[1]
    k_r, v_r = (t.repeat_interleave(rep, dim=1) for t in (k4, v4))
    return (lambda: F.scaled_dot_product_attention(q4, k_r, v_r, **kw),
            "k/v repeated")


def flash_timing(B, Sq, Sk, H, K, hd, causal, reps, device,
                 plain=True, cold=False, q_offset=0) -> dict:
    """``flash_forward`` in bf16 on seeded inputs of one shape (q's first
    row at key position ``q_offset``): an eager
    loop and graph replay of ``reps`` calls, SDPA the same two ways (and
    held to the kernel within the bf16 tolerance), the plain version over
    5 calls where ``plain``, and the bound.  With ``cold`` every timed
    loop and replay turns over enough distinct input sets that each set's
    q, K/V and out span more than twice the card's L2 before it comes
    back, so each call reads its operands from HBM, as a served layer
    reads cross K/V made long before; the L2-warm replay of one set is
    kept beside it (``*_warm_device_ms``)."""
    one = flash_inputs(B, Sq, Sk, H, K, hd, torch.bfloat16, device)
    set_bytes = sum(t.numel() * t.element_size() for t in one + one[:1])
    n_sets = 1 + math.ceil(
        2 * torch.cuda.get_device_properties(device).L2_cache_size
        / set_bytes) if cold else 1
    sets = [one] + [flash_inputs(B, Sq, Sk, H, K, hd, torch.bfloat16,
                                 device, seed=i) for i in range(1, n_sets)]
    q, k, v = one
    views = [tuple(t.view(B, -1, t.shape[1], hd) for t in qkv)
             for qkv in sets]
    turn = itertools.count()

    def call(qkv=None):
        qkv = qkv or sets[next(turn) % n_sets]
        return flash_forward(*qkv, causal=causal, n_rep=H // K,
                             q_offset=q_offset)
    ms, device_ms = cuda_ms(call, reps), graph_ms(call, reps)
    lib, lib_form = library_attention(*views[0], causal, q_offset)
    libs = [lib] + [library_attention(*qkv, causal, q_offset)[0]
                    for qkv in views[1:]]

    def lib_call():
        return libs[next(turn) % n_sets]()
    with sdpa_kernel(FUSED_SDPA):
        lib_ms = cuda_ms(lib_call, 10 * reps)
        lib_device_ms = graph_ms(lib_call, reps)
        warm = dict(warm_device_ms=graph_ms(lambda: call(one), reps),
                    lib_warm_device_ms=graph_ms(lib, reps)) if cold else {}
        lib_out = lib()
    plain_ms = cuda_ms(lambda: flash_forward_reference(
        q, k, v, causal=causal, n_rep=H // K, q_offset=q_offset), 5) \
        if plain else None
    lib_err = float((call(one).view_as(views[0][0]).float()
                     - lib_out.float()).abs().max())
    if lib_err > FLASH_TOL_BF16:
        raise AssertionError(f"flash {(B, Sq, Sk, H, K, hd, causal)}: "
                             f"kernel vs SDPA max |diff| {lib_err}")
    bound_ms, bound_by, nbytes, n_ops = flash_bound(q, k, v, causal,
                                                    q_offset)
    return dict(ms=ms, device_ms=device_ms, lib_ms=lib_ms,
                lib_device_ms=lib_device_ms, lib_form=lib_form,
                lib_err=lib_err, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, nbytes=nbytes, n_ops=n_ops,
                n_sets=n_sets, **warm)


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
    models = {(dt, b): Model(cfg, dt, backend=b, device=device)
              for dt in (torch.bfloat16, torch.float32)
              for b in ("cuda", "torch")}
    m32 = models[torch.float32, "cuda"]
    na, _ = m32.mixer_counts()
    n_attn = na * m32.n_units
    params = redraw_ssm_constants(m32.init_params(LM_SEED), LM_SEED)
    # the two bf16 servers share one cast of the weights
    params16 = models[torch.bfloat16, "cuda"].cast(params)
    servers = {(dt, b): LMServer(m, params16 if dt == torch.bfloat16
                                 else params, batch=B, max_len=max_len)
               for (dt, b), m in models.items()}
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
    logits, moe_routes = {}, {}
    for key, server in servers.items():
        state = server.model.init_decode_state(B, max_len)
        with recorded_routes() as moe_routes[key]:
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
    # MoE: (token, choice) routes of the prefill that differ between the
    # two attention engines, and the number of routes in all
    flips = {dt: route_flips(moe_routes[dt, "cuda"],
                             moe_routes[dt, "torch"])
             for dt in (torch.float32, torch.bfloat16)}
    if err32 > LM_LOGIT_TOL_F32 or err16 > LM_LOGIT_TOL_BF16:
        raise AssertionError(f"prefill logits cuda vs torch: f32 {err32} "
                             f"(tol {LM_LOGIT_TOL_F32}), bf16 {err16} (tol "
                             f"{LM_LOGIT_TOL_BF16}) of the largest |logit|;"
                             f" MoE routes differing (of all) f32 "
                             f"{flips[torch.float32]}, bf16 "
                             f"{flips[torch.bfloat16]}")

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
                err16_vs32=err16_vs32, dec_err=dec_err, steps=steps,
                n_attn=n_attn, flips=flips)


def redraw_ssm_constants(params: dict, seed: int) -> dict:
    """The mamba leaves the reference initialises to constants (``conv_x``
    and ``A_log`` zero, ``dt_bias`` zero, which make a fresh block pass
    nothing through its SSD scan) redrawn from ``seed`` as N(0, 0.5), in
    place, so the served path does the work a trained model does."""
    gen = None
    for pos in params["blocks"].values():
        if "ssm" not in pos:
            continue
        for key in ("conv_x", "A_log", "dt_bias"):
            t = pos["ssm"][key]
            if gen is None:
                gen = torch.Generator(device=t.device).manual_seed(seed)
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device,
                                dtype=t.dtype) * 0.5)
    return params


@contextlib.contextmanager
def recorded_routes():
    """Record every MoE layer's top-k expert choices (``moe.route``) while
    the block runs: a list of (tokens, k) index tensors on the host."""
    rec, orig = [], moe.route

    def route(probs, k, cap):
        out = orig(probs, k, cap)
        rec.append(out[1].reshape(-1, k).cpu())
        return out
    moe.route = route
    try:
        yield rec
    finally:
        moe.route = orig


def route_flips(a: list, b: list) -> tuple:
    """(differing, all) (token, choice) routes of two recordings."""
    if len(a) != len(b):
        raise AssertionError(f"MoE layers routed {len(a)} vs {len(b)}")
    return (sum(int((x != y).sum()) for x, y in zip(a, b)),
            sum(x.numel() for x in a))


def family_config(name: str, spec: dict):
    """A family's served configuration: ``.reduced()`` or full width with
    its depth cut to ``layers``."""
    cfg = get_config(name)
    if spec["reduced"]:
        return cfg.reduced()
    if spec["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=spec["layers"])
    return cfg


def lm_family_path(name: str, spec: dict, device) -> tuple:
    """One moe, ssm or hybrid family through ``lm_path``; the card's
    memory is released after it.  Returns (config, lm_path's result)."""
    cfg = family_config(name, spec)
    prompts = lm_prompts(cfg, spec["batch"], spec["prompt"])
    try:
        return cfg, lm_path(cfg, prompts, spec["new"], device)
    finally:
        if device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def encdec_generate(model, params, prompts: np.ndarray, enc, n_new: int,
                    max_len: int) -> dict:
    """Serve an encdec model greedily through its own entry points, as
    ``tests/test_models_smoke.py:67-92`` drives the reference:
    ``init_decode_state(params=, enc_embeds=)`` (the encoder and each
    decoder unit's cross K/V), ``prefill`` with that state, then
    ``decode_step`` per new token.  Returns the tokens (B, S + n_new), the
    prefill's logits in f32, ``flash_forward``'s launches in each of the
    three steps and their host-clock ms, each ended by a device sync."""
    B = prompts.shape[0]
    dev = model.device
    marks = []

    def mark():
        sync(dev)
        marks.append((time.perf_counter(), flash_forward.launches))
    with torch.inference_mode():
        mark()
        state = model.init_decode_state(B, max_len, params=params,
                                        enc_embeds=enc)
        mark()
        logits = model.prefill(params, prompts, state).float()
        tok = torch.argmax(logits, dim=-1)
        mark()
        new = []
        for _ in range(n_new):
            new.append(tok)
            lg, state = model.decode_step(params, state, tok[:, None])
            tok = torch.argmax(lg.float(), dim=-1)
        mark()
    out = [np.asarray(prompts, dtype=np.int32)]
    if new:
        out.append(torch.stack(new, dim=1).cpu().numpy().astype(np.int32))
    steps = ("init", "prefill", "decode")
    return dict(tokens=np.concatenate(out, axis=1), logits=logits,
                launches={s: b[1] - a[1] for s, a, b in
                          zip(steps, marks, marks[1:])},
                times={f"{s}_ms": (b[0] - a[0]) * 1e3 for s, a, b in
                       zip(steps, marks, marks[1:])})


def encdec_path(cfg, prompts: np.ndarray, enc, n_new: int, device) -> dict:
    """The encdec family's main path and its checks.  Seeded f32 master
    weights on ``device``; the served model computes in bf16 on
    ``backend="cuda"`` from weights cast once (as ``LMServer`` casts), so
    the cross K/V are those bf16 weights against the bf16 encoder output.
    Every launch count is set to 0 just before the served run and read
    just after: ``flash_forward`` once per encoder layer (non-causal, in
    ``init_decode_state``), twice per decoder layer in the prefill (causal
    self-attention, non-causal cross-attention with Sq != Sk), none in
    decode, all on the ``wgmma`` route, and no other kernel.  Then, at
    the same weights: f32 ``cuda`` and ``torch`` give the same greedy
    tokens and prefill logits within ``LM_LOGIT_TOL_F32``; bf16 prefill
    logits within ``LM_LOGIT_TOL_BF16``; teacher-forced f32
    ``decode_step`` from the f32 masters' state matches ``forward``."""
    B, S = prompts.shape
    max_len = S + n_new + 1
    models = {(dt, b): Model(cfg, dt, backend=b, device=device)
              for dt in (torch.bfloat16, torch.float32)
              for b in ("cuda", "torch")}
    m16, m32 = models[torch.bfloat16, "cuda"], models[torch.float32, "cuda"]
    params = m16.init_params(LM_SEED)
    params16 = m16.cast(params)
    numel = []
    tree_map(lambda t: numel.append(t.numel()), params)
    on_card = device.type == "cuda"
    want = dict(init=cfg.enc_layers * on_card,
                prefill=2 * m16.n_units * on_card, decode=0)

    reset_launches()
    served = encdec_generate(m16, params16, prompts, enc, n_new, max_len)
    counts = launch_counts()
    flash = counts.pop("flash")
    routes = dict(flash_forward.launches_by_route)
    if served["launches"] != want or flash != sum(want.values()) or \
            any(counts.values()) or \
            routes != {"wgmma": sum(want.values()), "simt": 0}:
        raise AssertionError(f"encdec: flash_forward launched "
                             f"{served['launches']} ({routes}), want {want};"
                             f" other kernels {counts}")
    out = served["tokens"]
    if out.shape != (B, S + n_new) or not np.array_equal(out[:, :S],
                                                         prompts) or \
            out.min() < 0 or out.max() >= cfg.vocab or \
            not torch.isfinite(served["logits"]).all():
        raise AssertionError(f"encdec: output {out.shape} out of range, "
                             f"prompt changed or logits not finite")
    warm = encdec_generate(m16, params16, prompts, enc, n_new, max_len)
    if not np.array_equal(warm["tokens"], out) or \
            warm["launches"] != want:
        raise AssertionError("encdec: a second run differs")

    f32 = {b: encdec_generate(models[torch.float32, b], params, prompts,
                              enc, n_new, max_len) for b in ("cuda", "torch")}
    if not np.array_equal(f32["cuda"]["tokens"], f32["torch"]["tokens"]):
        diff = np.argwhere(f32["cuda"]["tokens"] != f32["torch"]["tokens"])
        raise AssertionError(f"encdec f32 greedy tokens differ between cuda"
                             f" and torch first at (row, pos) "
                             f"{tuple(diff[0])}")
    torch16 = encdec_generate(models[torch.bfloat16, "torch"], params16,
                              prompts, enc, 0, max_len)
    err32 = rel_logit_err(f32["cuda"]["logits"], f32["torch"]["logits"])
    err16 = rel_logit_err(served["logits"], torch16["logits"])
    err16_vs32 = rel_logit_err(served["logits"], f32["torch"]["logits"])
    if err32 > LM_LOGIT_TOL_F32 or err16 > LM_LOGIT_TOL_BF16:
        raise AssertionError(f"encdec prefill logits cuda vs torch: f32 "
                             f"{err32} (tol {LM_LOGIT_TOL_F32}), bf16 "
                             f"{err16} (tol {LM_LOGIT_TOL_BF16})")

    steps = min(LM_TEACHER_STEPS, S)
    with torch.inference_mode():
        full = m32.forward(params, prompts[:, :steps], enc)
        state = m32.init_decode_state(B, steps + 1, params=params,
                                      enc_embeds=enc, dtype=torch.float32)
        got = []
        for i in range(steps):
            lg, state = m32.decode_step(params, state, prompts[:, i:i + 1])
            got.append(lg)
    got = torch.stack(got, dim=1)
    dec_err = float((got - full).abs().max())
    if not torch.allclose(got, full, rtol=LM_DECODE_TOL,
                          atol=LM_DECODE_TOL):
        raise AssertionError(f"encdec teacher-forced decode vs forward: "
                             f"max |diff| {dec_err} > {LM_DECODE_TOL}")
    return dict(tokens=out, launches=served["launches"], routes=routes,
                times=warm["times"], times_cold=served["times"],
                err32=err32, err16=err16, err16_vs32=err16_vs32,
                dec_err=dec_err, steps=steps, n_params=sum(numel))


def state_bytes(state: dict) -> int:
    return sum(t.numel() * t.element_size() for t in state.values()
               if isinstance(t, torch.Tensor))


def kv_quant_path(cfg, prompts: np.ndarray, n_new: int, device,
                  max_ratio: float = KV_QUANT_BYTES) -> dict:
    """The int8 KV cache through ``LMServer(kv_quant=True)``: served in bf16
    on ``backend="cuda"`` with launch counts set to 0 just before and read
    just after (one ``wgmma`` ``flash_forward`` per attention layer of the
    prefill, no other kernel); the bf16-cache server at the same weights
    timed in turns with it (bf16, int8, bf16: the second call of each
    kept); f32 greedy tokens ``cuda`` == ``torch`` with the int8 cache;
    the int8 state's bytes at most ``max_ratio`` of the bf16 state's."""
    B, S = prompts.shape
    max_len = S + n_new + 1
    models = {(dt, b): Model(cfg, dt, backend=b, device=device)
              for dt, b in ((torch.bfloat16, "cuda"), (torch.float32, "cuda"),
                            (torch.float32, "torch"))}
    m16 = models[torch.bfloat16, "cuda"]
    n_attn = m16.mixer_counts()[0] * m16.n_units
    params = m16.init_params(LM_SEED)
    params16 = m16.cast(params)
    q8 = LMServer(m16, params16, batch=B, max_len=max_len, kv_quant=True)
    bf = LMServer(m16, params16, batch=B, max_len=max_len)

    reset_launches()
    out = q8.generate(prompts, n_new)
    counts = launch_counts()
    launches = counts.pop("flash")
    routes = dict(flash_forward.launches_by_route)
    want = n_attn if device.type == "cuda" else 0
    if launches != want or any(counts.values()) or \
            routes != {"wgmma": want, "simt": 0}:
        raise AssertionError(f"int8 generate: flash_forward launched "
                             f"{launches} times ({routes}) for {n_attn} "
                             f"attention layers; other kernels {counts}")
    if out.shape != (B, S + n_new) or not np.array_equal(out[:, :S],
                                                         prompts):
        raise AssertionError(f"int8 generate: output {out.shape}")
    times = {}
    for name, server in (("bf16", bf), ("int8", q8), ("bf16", bf)):
        tokens = server.generate(prompts, n_new)
        times[name] = dict(server.last_times)
        if name == "int8" and not np.array_equal(tokens, out):
            raise AssertionError("int8 generate: a second call differs")
    agree = float((tokens[:, S:] == out[:, S:]).mean())
    tokens32 = {b: LMServer(models[torch.float32, b], params, batch=B,
                            max_len=max_len, kv_quant=True)
                .generate(prompts, n_new) for b in ("cuda", "torch")}
    if not np.array_equal(tokens32["cuda"], tokens32["torch"]):
        diff = np.argwhere(tokens32["cuda"] != tokens32["torch"])[0]
        raise AssertionError(f"int8 f32 greedy tokens differ between cuda "
                             f"and torch first at (row, pos) {tuple(diff)}")
    ratio = state_bytes(m16.init_decode_state(B, max_len, kv_quant=True)) \
        / state_bytes(m16.init_decode_state(B, max_len))
    if ratio > max_ratio:
        raise AssertionError(f"int8 state is {ratio:.4f} of the bf16 "
                             f"state's bytes (at most {max_ratio})")
    return dict(tokens=out, launches=launches, routes=routes, times=times,
                agree=agree, ratio=ratio, n_attn=n_attn)


def timed_steps(trainer, n: int) -> tuple:
    """``n`` train steps: (their records, the ms of each, host clock around
    a synchronised step)."""
    recs, ms = [], []
    sync = torch.cuda.synchronize if trainer.device.type == "cuda" \
        else (lambda: None)
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        recs.append(trainer.train_step())
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return recs, ms


def check_records(recs, what: str, vocab=None) -> None:
    """Finite losses and grad norms, grad norm > 0; with ``vocab`` the
    first loss within 0.2-3 x ln V (tests/test_models_smoke.py:51)."""
    for r in recs:
        if not (math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
                and r["grad_norm"] > 0):
            raise AssertionError(f"{what}: step record {r}")
    if vocab and not (0.2 * math.log(vocab) < recs[0]["loss"]
                      < 3.0 * math.log(vocab)):
        raise AssertionError(f"{what}: first loss {recs[0]['loss']} not "
                             f"within 0.2-3 x ln {vocab}")


def same_state(a, b, what: str) -> None:
    """Two trainers' params, moments and residuals bit for bit."""
    la, lb = (tree_flatten(t.state_tree())[0] for t in (a, b))
    if len(la) != len(lb):
        raise AssertionError(f"{what}: {len(la)} vs {len(lb)} state leaves")
    for i, (x, y) in enumerate(zip(la, lb)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: state leaf {i} differs")


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def pairs(recs) -> list:
    """(loss, grad norm) of each step record."""
    return [(r["loss"], r["grad_norm"]) for r in recs]


def host_leaves(tree) -> list:
    return [t.detach().cpu() for t in tree_flatten(tree)[0]]


def same_leaves(want: list, tree, what: str) -> None:
    """``tree``'s leaves bit for bit ``want`` (host copies)."""
    got = tree_flatten(tree)[0]
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} vs {len(want)} leaves")
    for i, (a, b) in enumerate(zip(want, got)):
        if not torch.equal(a, b.detach().cpu()):
            raise AssertionError(f"{what}: leaf {i} differs")


def train_path(device, card: str, keep: dict = None) -> dict:
    """Phase 14: the training slice at smollm-360m's full width.  ``keep``
    gets each run's (loss, grad norm) pairs and final params on the host,
    what phase 15 holds its mesh runs to."""
    Trainer = train_launcher.Trainer
    cfg = get_config(TRAIN_ARCH)
    out = {}
    keep = {} if keep is None else keep

    # (a) full width, train_4k's sequence length
    tr = Trainer(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, opt_state="f32",
                 device=device)
    tr.init_state(LM_SEED)
    n_params = sum(p.numel() for p in tree_flatten(tr.params)[0])
    torch.cuda.reset_peak_memory_stats(device)
    recs, ms = timed_steps(tr, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated(device)
    check_records(recs, "full width", cfg.vocab)
    keep["full"] = (pairs(recs), host_leaves(tr.params), peak)
    # one more step, its products counted for phase 17's dry run of this
    # cell; apart, since FlopCounterMode decomposes some backward ops
    # (the embedding's), which changes the gradient's bits
    with FlopCounterMode(display=False) as step_flops:
        tr.train_step()
    step_ms = sum(ms[1:]) / len(ms[1:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = _model_flops(cfg, ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH,
                                          "train"))
    share = flops / (step_ms / 1e3) / BF16_OPS_PER_S
    out.update(step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
               peak_bytes=peak, flop_share=share,
               step_flops=step_flops.get_total_flops())
    print(f"training full width: {cfg.name} ({n_params} params) "
          f"Trainer(batch={TRAIN_BATCH}, seq_len={TRAIN_SEQ}) in bf16 with "
          f"f32 masters and f32 Adam moments, remat, backend=torch: losses "
          f"{[round(r['loss'], 4) for r in recs]} (ln V "
          f"{math.log(cfg.vocab):.4f}), grad norms "
          f"{[round(r['grad_norm'], 4) for r in recs]}; ms per step "
          f"{[round(m, 1) for m in ms]} (steps 2-{TRAIN_STEPS} mean "
          f"{step_ms:.1f} ms), {out['tokens_per_s']:.0f} tokens/s, peak "
          f"memory {peak / 2**30:.2f} GiB "
          f"(torch.cuda.max_memory_allocated), MODEL_FLOPS "
          f"(launch.dryrun._model_flops: 6·N_active·tokens) per step time "
          f"{share:.2%} of {BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16; "
          f"a 4th step's products {out['step_flops']} FLOPs "
          f"(FlopCounterMode) "
          f"[{card}]")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the restart contract at the reference CLI's defaults
    def make(**kw):
        t = Trainer(cfg, batch=RESTART_BATCH, seq_len=RESTART_SEQ,
                    device=device, **kw)
        t.init_state(LM_SEED)
        return t
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck")
        tr1 = make()
        timed_steps(tr1, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr1.save(ck)
        save_s = time.perf_counter() - t0
        ck_bytes = sum(os.path.getsize(os.path.join(ck, "step_00000002", n))
                       for n in os.listdir(os.path.join(ck, "step_00000002")))
        ref, ref_ms = timed_steps(tr1, 2)
        check_records(ref, "restart")
        tr2 = make()
        t0 = time.perf_counter()
        got_step = tr2.restore(ck)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got, _ = timed_steps(tr2, 2)
        if got_step != 2 or got != ref:
            raise AssertionError(f"restart contract: restored step "
                                 f"{got_step}, records {got} != {ref}")
        same_state(tr1, tr2, "restart contract (restore)")
        del tr2
        tr3 = Trainer(cfg, batch=RESTART_BATCH, seq_len=RESTART_SEQ,
                      device=device)
        log_path, hb_dir = os.path.join(tmp, "log.jsonl"),             os.path.join(tmp, "hb")
        loop = train_launcher.run_loop(tr3, steps=4, ckpt_dir=ck,
                                       ckpt_every=2, log_path=log_path,
                                       keep=1, hb_dir=hb_dir)
        with open(log_path) as f:
            logged = [json.loads(line) for line in f]
        hb = Heartbeat.survey(hb_dir, timeout_s=1e9)
        if ([r["step"] for r in loop] != [3, 4] or
                [(r["loss"], r["grad_norm"]) for r in loop] !=
                [(r["loss"], r["grad_norm"]) for r in ref] or
                ckpt.latest_step(ck) != 4 or
                sorted(os.listdir(ck)) != ["LATEST", "step_00000004"] or
                [r["step"] for r in logged] != [3, 4] or hb[0]["step"] != 4):
            raise AssertionError(f"run_loop resume: records {loop}, log "
                                 f"{logged}, heartbeat {hb}, checkpoints "
                                 f"{sorted(os.listdir(ck))}")
        same_state(tr1, tr3, "restart contract (run_loop)")
        keep["restart"] = (pairs(ref), host_leaves(tr1.params))
        f32_state = tree_bytes(tr1.opt_state)
        del tr1, tr3
    out.update(save_s=save_s, restore_s=restore_s, ckpt_bytes=ck_bytes,
               restart_step_ms=ref_ms)
    print(f"training restart contract at {RESTART_BATCH} x {RESTART_SEQ}: 4 "
          f"steps == 2 steps, save, a new Trainer's restore and 2 steps == "
          f"run_loop resuming from that checkpoint (its checkpoint at step 4"
          f", keep=1, the JSONL log and the heartbeat written): losses, "
          f"grad norms, params and moments bit for bit (steps under "
          f"torch.use_deterministic_algorithms); checkpoint "
          f"{ck_bytes / 1e9:.3f} GB, save {save_s:.2f} s, restore "
          f"{restore_s:.2f} s; steps 3-4 {[round(m, 1) for m in ref_ms]} ms "
          f"[{card}]")

    # (c) int8 moments and compressed gradients
    for kw in (dict(opt_state="int8"), dict(compress_grads=True)):
        t = make(**kw)
        recs, _ = timed_steps(t, 2)
        check_records(recs, f"training {kw}")
        keep[next(iter(kw))] = (pairs(recs), host_leaves(t.params))
        if "opt_state" in kw:
            out["int8_state_bytes"] = tree_bytes(t.opt_state)
        print(f"training {kw} at {RESTART_BATCH} x {RESTART_SEQ}: losses "
              f"{[round(r['loss'], 4) for r in recs]}, grad norms "
              f"{[round(r['grad_norm'], 4) for r in recs]}")
        del t
    out["f32_state_bytes"] = f32_state
    print(f"Adam state bytes: int8 moments {out['int8_state_bytes']} "
          f"against f32 moments {f32_state} "
          f"({out['int8_state_bytes'] / f32_state:.4f})")

    # (d) the card against the CPU, reduced config in f32
    rcfg = cfg.reduced()
    cpu = Trainer(rcfg, batch=2, seq_len=32, compute_dtype=torch.float32,
                  device="cpu")
    cpu.init_state(LM_SEED)
    card_tr = Trainer(rcfg, batch=2, seq_len=32,
                      compute_dtype=torch.float32, device=device)
    card_tr.params, card_tr.opt_state, card_tr.residuals = (
        tree_map(lambda a: a.to(device), t) for t in
        (cpu.params, cpu.opt_state, cpu.residuals))
    l_cpu, g_cpu = cpu._value_and_grad(cpu.batch_inputs(0)[0])
    l_card, g_card = card_tr._value_and_grad(card_tr.batch_inputs(0)[0])
    grad_err = 0.0
    for a, b in zip(tree_flatten(g_cpu)[0], tree_flatten(g_card)[0]):
        grad_err = max(grad_err, float((b.cpu() - a).abs().max()
                                       / a.abs().max().clamp(min=1e-30)))
    loss_err = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    steps = [(cpu.train_step()["loss"], card_tr.train_step()["loss"])
             for _ in range(3)]
    step_err = max(abs(b - a) / abs(a) for a, b in steps)
    if loss_err > TRAIN_LOSS_RTOL or grad_err > TRAIN_GRAD_TOL or \
            step_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"card vs CPU: loss {loss_err}, grads "
                             f"{grad_err}, steps {steps}")
    print(f"training card vs CPU ({rcfg.name} reduced, f32, 2 x 32): loss "
          f"rel {loss_err:.3g}, gradients max|diff| / max|grad| per leaf "
          f"{grad_err:.3g} (tol {TRAIN_LOSS_RTOL}, {TRAIN_GRAD_TOL}); 3 "
          f"train steps' losses rel {step_err:.3g}")
    return out


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def dp_path(device, card: str, ref: dict) -> dict:
    """Phase 15: phase 14's runs through ``Trainer(mesh=)`` on a one-rank
    group (NCCL on the card, gloo on the CPU), each bit for bit the
    mesh-less run in ``ref`` (``train_path``'s ``keep``), and
    ``compressed_psum`` against its plain version.  The group is
    destroyed on the way out."""
    Trainer = train_launcher.Trainer
    cfg = get_config(TRAIN_ARCH)
    initialize_from_env(f"127.0.0.1:{free_port()}", 1, 0, device=device,
                        timeout_s=DP_TIMEOUT_S)
    try:
        mesh = make_debug_mesh(1, 1, device=device)
        out = {"backend": dist.get_backend(), "mesh": mesh.shape,
               "mesh_device": str(mesh.device)}

        # (a) full width, through the mesh
        tr = Trainer(cfg, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                     opt_state="f32", mesh=mesh)
        tr.init_state(LM_SEED)
        torch.cuda.reset_peak_memory_stats(device)
        recs, ms = timed_steps(tr, TRAIN_STEPS)
        peak = torch.cuda.max_memory_allocated(device)
        want, want_params, ref_peak = ref["full"]
        if pairs(recs) != want:
            raise AssertionError(f"mesh run {pairs(recs)} != phase 14's "
                                 f"{want}")
        same_leaves(want_params, tr.params, "mesh run params")
        step_ms = sum(ms[1:]) / len(ms[1:])
        tokens = TRAIN_BATCH * TRAIN_SEQ
        ar = [r["all_reduce_ms"] for r in recs]
        out.update(step_ms=step_ms, tokens_per_s=tokens / (step_ms / 1e3),
                   ms=ms, all_reduce_ms=ar,
                   pack_ms=[r["pack_ms"] for r in recs],
                   scale_ms=[r["scale_ms"] for r in recs],
                   all_reduce_bytes=recs[-1]["all_reduce_bytes"],
                   grad_bytes=recs[-1]["grad_bytes"], peak_bytes=peak,
                   ref_peak_bytes=ref_peak, tok_spec=list(tr.tok_spec),
                   replicas=tr.replicas)
        print(f"data parallel full width over {out['backend']} (one rank, "
              f"mesh {mesh.shape} on {mesh.device}): {cfg.name} "
              f"Trainer(batch={TRAIN_BATCH}, seq_len={TRAIN_SEQ}, mesh=...) "
              f"{TRAIN_STEPS} steps: losses and grad norms {want} and "
              f"params bit for bit phase 14's; ms per step "
              f"{[round(m, 1) for m in ms]} (steps 2-{TRAIN_STEPS} mean "
              f"{step_ms:.1f} ms), {out['tokens_per_s']:.0f} tokens/s; "
              f"by {'CUDA events' if mesh.device.type == 'cuda' else 'host clock'}"
              f", the copy into the buffer "
              f"{[round(m, 3) for m in out['pack_ms']]} ms, the all-reduce "
              f"{[round(m, 3) for m in ar]} ms, the division "
              f"{[round(m, 3) for m in out['scale_ms']]} ms, over "
              f"{out['all_reduce_bytes']} bytes ({out['grad_bytes']} of "
              f"gradients, the rest ALIGN padding and the loss); peak "
              f"memory {peak / 2**30:.2f} GiB against phase 14's "
              f"{ref_peak / 2**30:.2f} GiB [{card}]")
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # (b) the restart contract through the mesh
        def make(**kw):
            t = Trainer(cfg, batch=RESTART_BATCH, seq_len=RESTART_SEQ,
                        mesh=mesh, **kw)
            t.init_state(LM_SEED)
            return t
        with tempfile.TemporaryDirectory() as tmp:
            ck = os.path.join(tmp, "ck")
            tr1 = make()
            timed_steps(tr1, 2)
            tr1.save(ck)
            r34, _ = timed_steps(tr1, 2)
            tr2 = Trainer(cfg, batch=RESTART_BATCH, seq_len=RESTART_SEQ,
                          mesh=mesh)
            got_step = tr2.restore(ck)
            got, _ = timed_steps(tr2, 2)
            want, want_params = ref["restart"]
            if got_step != 2 or pairs(got) != pairs(r34) or \
                    pairs(r34) != want:
                raise AssertionError(f"mesh restart: step {got_step}, "
                                     f"{pairs(got)} / {pairs(r34)} != "
                                     f"{want}")
            same_state(tr1, tr2, "mesh restart (restore)")
            same_leaves(want_params, tr1.params, "mesh restart params")
            del tr1, tr2
        print(f"data parallel restart contract at {RESTART_BATCH} x "
              f"{RESTART_SEQ} through the mesh: 2 steps, save, 2 steps == a "
              f"new Trainer(mesh=)'s restore and 2 steps == phase 14's "
              f"mesh-less run, losses, grad norms and params bit for bit")

        # (c) int8 moments and compressed gradients through the mesh
        for kw in (dict(opt_state="int8"), dict(compress_grads=True)):
            t = make(**kw)
            recs, _ = timed_steps(t, 2)
            want, want_params = ref[next(iter(kw))]
            if pairs(recs) != want:
                raise AssertionError(f"mesh {kw}: {pairs(recs)} != {want}")
            same_leaves(want_params, t.params, f"mesh {kw} params")
            print(f"data parallel {kw} at {RESTART_BATCH} x {RESTART_SEQ}: "
                  f"{pairs(recs)} and params bit for bit phase 14's")
            del t
        gc.collect()
        torch.cuda.empty_cache()

        # (d) compressed_psum over the group, on tensors on the device
        gen = torch.Generator(device=device).manual_seed(LM_SEED)
        g = torch.randn(PSUM_SHAPE, device=device, generator=gen)
        r = torch.randn(PSUM_SHAPE, device=device, generator=gen) * 0.01
        with mesh:
            got, got_res = compressed_psum(g, r, "data")
        want, want_res = compressed_psum_reference([g.cpu()], [r.cpu()])
        if not (torch.equal(got.cpu(), want) and
                torch.equal(got_res.cpu(), want_res[0])):
            raise AssertionError("compressed_psum on the device differs "
                                 "from its plain version")
        out["psum_shape"] = list(PSUM_SHAPE)
        print(f"compressed_psum over {out['backend']} on {g.device}, "
              f"{tuple(PSUM_SHAPE)} f32: output and residual bit for bit "
              f"its plain version on the CPU")
    finally:
        dist.destroy_process_group()
    return out


def tp_plan(device_type: str = "cuda", small: bool = False) -> dict:
    """What phase 16 runs; ``small`` shrinks it to .reduced() configs at a
    tiny shape, for a rehearsal on the CPU."""
    plan = dict(device_type=device_type, full=TP_FULL, batch=TP_BATCH,
                seq=TP_SEQ, steps=TP_STEPS, reduced=TP_REDUCED, small=small)
    if small:
        plan.update(batch=4, seq=32, reduced=TP_REDUCED[:1],
                    full=((TP_FULL[0][0], None, TP_FULL[0][2]),))
    return plan


def tp_config(arch: str, layers, plan):
    cfg = get_config(arch)
    if plan["small"]:
        return cfg.reduced()
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def tp_mesh(shape, device, backend: str):
    """A (data, model) ``Mesh`` over the whole group.  Over gloo on the one
    card the ``DeviceMesh`` is built on the CPU (its groups are gloo's) and
    the mesh's device is the card; over NCCL it is ``make_debug_mesh``."""
    from repro_torch.launch.mesh import Mesh
    from torch.distributed.device_mesh import init_device_mesh
    if backend == "nccl":
        return make_debug_mesh(*shape, device=device)
    return Mesh(dict(zip(("data", "model"), shape)),
                init_device_mesh("cpu", shape,
                                 mesh_dim_names=("data", "model")), device)


def tp_probe(device) -> dict:
    """Each collective the port calls, on card tensors over the group:
    "ok" or the first line of its error."""
    x = torch.arange(8, dtype=torch.float32, device=device) + dist.get_rank()
    n = dist.get_world_size()
    out = {}
    for name, fn in (
            ("all_gather", lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(n)], x)),
            ("reduce_scatter", lambda: dist.reduce_scatter(
                torch.empty(8 // n, device=device), list(x.chunk(n)))),
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("all_reduce_max", lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.MAX)),
            ("broadcast", lambda: dist.broadcast(x.clone(), src=0))):
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize()
            out[name] = "ok"
        except Exception as e:  # noqa: BLE001 — reported, then raised
            out[name] = str(e).splitlines()[0]
    return out


def tp_full_run(arch, layers, mesh, device, tmp, rank, plan) -> dict:
    """One full-size run: step 0's loss and gradient (the cosine with the
    mesh-less gradient on rank 0), then ``TP_STEPS`` timed steps; this
    rank's stored bytes, peak memory and the step's collective bytes."""
    from repro_torch.launch.dryrun import _analytic_memory
    cfg = tp_config(arch, layers, plan)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    tr = train_launcher.Trainer(cfg, batch=plan["batch"],
                                seq_len=plan["seq"], mesh=mesh)
    tr.init_state(LM_SEED)
    loss0, grads = tr.loss_and_grads()
    whole = tr.gathered(grads, tr.p_specs)
    del grads
    cos = None
    if rank == 0:
        want = torch.load(os.path.join(tmp, f"{arch}.pt"),
                          map_location=device)
        dot = na = nb = 0.0
        for a, b in zip(tree_flatten(whole)[0], want):
            a, b = a.double(), b.double()
            dot += float((a * b).sum())
            na += float((a * a).sum())
            nb += float((b * b).sum())
        cos = dot / math.sqrt(na * nb)
        del want
    del whole
    recs, ms = timed_steps(tr, plan["steps"])
    n = math.prod(mesh.shape.values())
    analytic = _analytic_memory(cfg, ShapeConfig(
        "train", plan["seq"], plan["batch"], "train"), mesh, 1, "f32")
    out = {"loss0": float(loss0), "cosine": cos, "records": pairs(recs),
           "ms": ms, "param_bytes": tree_bytes(tr.params),
           "analytic_param_bytes": analytic["params"],
           "n_params": cfg.param_count(), "ranks": n,
           "adam_bytes": tree_bytes(tr.opt_state),
           "peak_bytes": torch.cuda.max_memory_allocated(device)
           if cuda else 0,
           "collective_bytes": recs[-1]["collective_bytes"],
           "all_reduce_ms": [r["all_reduce_ms"] for r in recs]}
    del tr
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def tp_reduced(arch, mesh=None, device=None):
    """A trainer of ``arch``'s .reduced() in f32 at (d)'s shape, its state
    drawn from ``LM_SEED``."""
    tr = train_launcher.Trainer(get_config(arch).reduced(),
                                batch=TP_REDUCED_BATCH,
                                seq_len=TP_REDUCED_SEQ, mesh=mesh,
                                compute_dtype=torch.float32, device=device)
    tr.init_state(LM_SEED)
    return tr


def tp_rank(rank, world, init, tmp, backend, plan, results) -> None:
    """One rank of phase 16: join the group, probe the collectives, run
    (a)-(c) at full size and (d) on the reduced configs, and put its
    results (or its traceback) on ``results``."""
    import traceback
    try:
        if plan["device_type"] == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(
                                    seconds=DP_TIMEOUT_S))
        reset_launches()
        out = {"probe": tp_probe(device), "full": {}, "reduced": {}}
        meshes = {}
        for shape in ((2, 2), (1, 4)):
            meshes[shape] = tp_mesh(shape, device, backend)
        for arch, layers, shapes in plan["full"]:
            for shape in shapes:
                t0 = time.perf_counter()
                out["full"][arch, shape] = tp_full_run(
                    arch, layers, meshes[shape], device, tmp, rank, plan)
                out["full"][arch, shape]["wall_s"] = \
                    time.perf_counter() - t0
        t0 = time.perf_counter()
        for arch in plan["reduced"]:
            tr = tp_reduced(arch, meshes[2, 2])
            out["reduced"][arch] = pairs([tr.train_step()
                                          for _ in range(TP_REDUCED_STEPS)])
        tr = tp_reduced(plan["reduced"][0], meshes[2, 2])
        for _ in range(2):
            tr.train_step()
        tr.save(os.path.join(tmp, "ck"))
        out["uninterrupted"] = pairs([tr.train_step()])
        t2 = tp_reduced(plan["reduced"][0], meshes[1, 4])
        out["restored"] = (t2.restore(os.path.join(tmp, "ck")),
                           pairs([t2.train_step()]))
        out["reduced_wall_s"] = time.perf_counter() - t0
        out["launches"] = launch_counts()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — carried to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(world, tmp, backend, plan, target=None) -> list:
    """``target`` (``tp_rank`` by default) in ``world`` spawned processes
    over a localhost TCP rendezvous; their results by rank.  Raises on an
    error in any rank or after ``TP_JOIN_S``; every process is joined or
    killed."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=target or tp_rank,
                         args=(r, world, init, tmp, backend, plan,
                               results))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + TP_JOIN_S
    try:
        while len(out) < world:
            try:
                rank, ok, val = results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise AssertionError(f"tensor-parallel ranks "
                                     f"{sorted(set(range(world)) - set(out))}"
                                     f" gave no result in {TP_JOIN_S} s")
            if not ok:
                raise AssertionError(f"tensor-parallel rank {rank} "
                                     f"failed:\n{val}")
            out[rank] = val
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def tp_references(device, tmp, plan) -> dict:
    """The mesh-less trainer on the device: for (a)-(c) step 0's loss (its
    gradient saved to ``tmp`` for rank 0), for (d) each reduced config's
    records."""
    ref = {"full": {}, "reduced": {}}
    for arch, layers, _ in plan["full"]:
        tr = train_launcher.Trainer(tp_config(arch, layers, plan),
                                    batch=plan["batch"], seq_len=plan["seq"],
                                    device=device)
        tr.init_state(LM_SEED)
        loss, grads = tr.loss_and_grads()
        torch.save([g.float().cpu() for g in tree_flatten(grads)[0]],
                   os.path.join(tmp, f"{arch}.pt"))
        ref["full"][arch] = float(loss)
        del tr, grads
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    for arch in plan["reduced"]:
        tr = tp_reduced(arch, device=device)
        ref["reduced"][arch] = pairs([tr.train_step()
                                      for _ in range(TP_REDUCED_STEPS)])
    return ref


def tp_path(device, card: str, plan=None) -> dict:
    """Phase 16: tensor-parallel training on meshes over gloo whose four
    ranks share the one card (NCCL takes one rank a card).  This rehearses
    the exchanges (their order, shapes and bytes) with the card's compute;
    it does not measure them: gloo stages every collective through host
    memory, so no time here says what NVLink would take.  (a)-(c) hold the
    mesh runs to the mesh-less trainer on the card (``tp_references``) by
    the loss and the gradient's cosine, (d) by ``tests/test_torch_tp.py``'s
    bounds and a checkpoint restored on another mesh.  With four cards the
    same ranks run again over NCCL, one a card."""
    plan = plan or tp_plan()
    out: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ref = tp_references(device, tmp, plan)
        out["reference_s"] = time.perf_counter() - t0
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = spawn_ranks(TP_RANKS, tmp, "gloo", plan)
        out["ranks_s"] = time.perf_counter() - t0
        n_cards = torch.cuda.device_count()
        nccl = spawn_ranks(TP_RANKS, tmp, "nccl", plan) \
            if n_cards >= TP_RANKS else None
    for label, runs in (("gloo", res), ("nccl", nccl)):
        if runs is None:
            print(f"nccl tensor-parallel run: {n_cards} card(s), not run "
                  f"(NCCL takes one rank a card; {TP_RANKS} are needed)")
            continue
        out[label] = tp_check(runs, ref, label, card, plan)
    return out


def tp_check(res: list, ref: dict, label: str, card: str, plan) -> dict:
    """Phase 16's checks on one set of ranks' results, and its lines."""
    out = {"probe": res[0]["probe"], "full": {}, "reduced": {}}
    for rank, r in enumerate(res):
        if any(v != "ok" for v in r["probe"].values()):
            raise AssertionError(f"rank {rank}: {label} refused a "
                                 f"collective on card tensors: "
                                 f"{r['probe']}")
        if any(r["launches"].values()):
            raise AssertionError(f"rank {rank} launched kernels: "
                                 f"{r['launches']}")
    print(f"tensor parallel over {label}: every collective the port calls "
          f"takes card tensors ({', '.join(res[0]['probe'])}) [{card}]")
    for arch, layers, shapes in plan["full"]:
        for shape in shapes:
            runs = [r["full"][arch, shape] for r in res]
            want = ref["full"][arch]
            rel = abs(runs[0]["loss0"] - want) / abs(want)
            cos = runs[0]["cosine"]
            if any(x["loss0"] != runs[0]["loss0"] or
                   x["records"] != runs[0]["records"] for x in runs):
                raise AssertionError(f"{arch} {shape}: the ranks disagree")
            check_records([{"loss": a, "grad_norm": b}
                           for a, b in runs[0]["records"]],
                          f"{arch} {shape}")
            if rel > TP_LOSS_REL or cos < TP_COSINE:
                raise AssertionError(f"{arch} {shape}: step 0 loss rel "
                                     f"{rel}, gradient cosine {cos}")
            key = f"{arch} {shape[0]}x{shape[1]}"
            out["full"][key] = {k: [x[k] for x in runs] for k in (
                "param_bytes", "adam_bytes", "peak_bytes", "ms",
                "collective_bytes", "all_reduce_ms")}
            out["full"][key].update(
                loss_rel=rel, cosine=cos, loss0=runs[0]["loss0"],
                records=runs[0]["records"], want_loss0=want,
                analytic_param_bytes=runs[0]["analytic_param_bytes"],
                wall_s=runs[0]["wall_s"])
            cut = "" if layers is None else \
                f", depth cut {get_config(arch).n_layers} -> {layers}"
            print(f"tensor parallel {key} over {label}: {arch}"
                  f"{cut} ({runs[0]['n_params']} params) "
                  f"Trainer(batch={plan['batch']}, seq_len={plan['seq']}) "
                  f"bf16: step "
                  f"0 loss {runs[0]['loss0']:.6f} vs mesh-less {want:.6f} "
                  f"(rel {rel:.3g}, tol {TP_LOSS_REL:.3g}), gradient cosine "
                  f"{cos:.6f} (at least {TP_COSINE}); losses and grad norms "
                  f"{runs[0]['records']}; {runs[0]['wall_s']:.1f} s [{card}]")
            for rank, x in enumerate(runs):
                print(f"  rank {rank}: stored f32 params {x['param_bytes']} B"
                      f" (_analytic_memory params P*4/n "
                      f"{x['analytic_param_bytes']:.0f} B), Adam state "
                      f"{x['adam_bytes']} B, peak memory "
                      f"{x['peak_bytes'] / 2**30:.2f} GiB, ms per step "
                      f"{[round(m, 1) for m in x['ms']]}, bytes by kind "
                      f"{x['collective_bytes']} [{card}]")
    for arch in plan["reduced"]:
        got, want = res[0]["reduced"][arch], ref["reduced"][arch]
        if any(r["reduced"][arch] != got for r in res):
            raise AssertionError(f"{arch} reduced: the ranks disagree")
        errs = [max(abs(a - b) / abs(b) for a, b in zip(g, w))
                for g, w in zip(got, want)]
        if errs[0] > TP_STEP0_REL or max(errs[1:]) > TP_LATER_REL:
            raise AssertionError(f"{arch} reduced on (2, 2): {got} vs the "
                                 f"mesh-less {want}")
        out["reduced"][arch] = errs
    step, recs = res[0]["restored"]
    want = res[0]["uninterrupted"][0][0]
    if step != 2 or abs(recs[0][0] - want) > TP_RESTORE_RTOL * abs(want):
        raise AssertionError(f"(2, 2) checkpoint on (1, 4): step {step}, "
                             f"loss {recs[0][0]} vs {want}")
    out["restored_rel"] = abs(recs[0][0] - want) / abs(want)
    print(f"tensor parallel reduced f32 on (2, 2) over {label}: "
          + ", ".join(f"{a} step rel errors {[f'{e:.2g}' for e in errs]}"
                      for a, errs in out["reduced"].items())
          + f" (tol {TP_STEP0_REL}, then {TP_LATER_REL}); a (2, 2) "
          f"checkpoint at step 2 restored on (1, 4) continues the loss to "
          f"rel {out['restored_rel']:.3g} (tol {TP_RESTORE_RTOL}); "
          f"{res[0]['reduced_wall_s']:.1f} s [{card}]")
    return out


# the dry run's child for phase 14's cell: the same Trainer on a one-rank
# mesh of a fake world, its step traced on meta tensors
DRYRUN_PHASE14_CHILD = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.configs import get_config
from repro_torch.launch.cost_analysis import fake_world, trace_step
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import Trainer
with fake_world(1):
    tr = Trainer(get_config({arch!r}), batch={batch}, seq_len={seq},
                 opt_state="f32", mesh=make_debug_mesh(1, 1, device="meta"),
                 device="meta")
    got = trace_step(tr)
print(json.dumps({{"flops": got.cost.flops, "memory": got.memory,
                  "trace_s": got.trace_s}}))
"""


# the dry run's child for one architecture's serving cells on the (16, 16)
# mesh: (shape, kv_quant) each, its record saved by run_cell
DRYRUN_SERVE_CHILD = """
import sys
sys.path.insert(0, {src!r})
from repro_torch.launch.dryrun import run_cell
for shape, kv_quant in {cells!r}:
    run_cell({arch!r}, shape, "single", kv_quant=kv_quant)
"""


def dryrun_path(card: str, train: dict) -> dict:
    """Phase 17: the port's dry run (``launch/dryrun.py`` over
    ``launch/cost_analysis.py``), no JAX and no card: (a) every
    architecture's ``train_4k`` cell on the (16, 16) mesh and those of
    ``DRYRUN_MULTI_ARCHS`` on (2, 16, 16), one process a cell on the
    host's cores, each record read
    from ``experiments/dryrun_torch`` (an ``error`` or a missing record
    fails); (b) phase 14's own cell on a one-rank mesh: its FLOPs equal
    the ``FlopCounterMode`` count of a step of phase 14's, and its
    arguments plus temporaries lie within ``DRYRUN_PEAK_BAND`` of the
    peak phase 14 measured; (c) the serving cells
    (``DRYRUN_SERVE_SHAPES``) on the (16, 16) mesh, the decode and
    long-context ones also with ``--kv-quant``: each record ``ok``, or,
    run in this process, ``skipped`` where the reference skips it."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.configs import SHAPES, shape_applicable
    from repro_torch.launch.cost_analysis import peak_bytes
    from repro_torch.launch.dryrun import HBM_BYTES, RESULTS_DIR, run_cell

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    # (name, argv): phase 14's cell, then one process a (arch, mesh),
    # the longest first
    jobs = [("phase14", [sys.executable, "-c", DRYRUN_PHASE14_CHILD.format(
        src=os.path.join(root, "src"), arch=TRAIN_ARCH, batch=TRAIN_BATCH,
        seq=TRAIN_SEQ)])]
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch"]
    # the records each job writes: (arch, shape, mesh name)
    cells_of = {"phase14": []}
    skipped = []
    for arch in DRYRUN_ARCHS:
        for mesh in ("single",) + (("multi",) if arch in DRYRUN_MULTI_ARCHS
                                   else ()):
            jobs.append((f"{arch}/{mesh}", cli + [
                arch, "--shape", "train_4k", "--mesh", mesh]))
            cells_of[jobs[-1][0]] = [(arch, "train_4k", mesh)]
        # the serving cells of one architecture in one process: a process
        # takes ~20 s to start on the card host, a decode cell ~5 s
        serve = [("prefill_32k", False)]
        for shape in DRYRUN_SERVE_SHAPES[1:]:
            if shape_applicable(get_config(arch), SHAPES[shape])[0]:
                serve += [(shape, False), (shape, True)]
            else:
                skipped.append((arch, shape))
        jobs.append((f"{arch}/serving", [
            sys.executable, "-c", DRYRUN_SERVE_CHILD.format(
                src=os.path.join(root, "src"), arch=arch, cells=serve)]))
        cells_of[jobs[-1][0]] = [
            (arch, shape, "single__kvq8" if kvq else "single")
            for shape, kvq in serve]
    started = time.time()

    def run(job):
        name, argv = job
        t0 = time.perf_counter()
        p = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                           text=True, timeout=DRYRUN_TIMEOUT_S)
        if p.returncode:
            raise AssertionError(f"dry run {name}: exit {p.returncode}\n"
                                 f"{p.stderr[-3000:]}")
        return name, p.stdout, time.perf_counter() - t0

    workers = max(1, min(len(jobs), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as ex:
        done = {name: (stdout, wall) for name, stdout, wall in
                ex.map(run, jobs)}
    cells = []
    n_cells = sum(len(c) for c in cells_of.values())
    print(f"dry run of train_4k and the serving cells ({n_cells} cells in "
          f"{len(jobs) - 1} processes, {workers} at a time: `python -m "
          f"repro_torch.launch.dryrun --arch A --shape train_4k --mesh M` "
          f"each, on (2, 16, 16) only for {', '.join(DRYRUN_MULTI_ARCHS)}, "
          f"and one process an architecture running `run_cell` for "
          f"its serving cells on the (16, 16) mesh; "
          f"meta tensors on a fake world, H100 datasheet roofline "
          f"constants):")
    for name, arch, shape, mesh in [(n, *c) for n, _ in jobs
                                    for c in cells_of[n]]:
        path = os.path.join(RESULTS_DIR, f"{arch}__{shape}__{mesh}.json")
        with open(path) as f:
            rec = json.load(f)
        if rec["timestamp"] < started or rec["status"] != "ok":
            raise AssertionError(f"dry run {name}: {rec.get('status')} "
                                 f"{rec.get('error', '')} (record of "
                                 f"{rec['timestamp']}, phase started "
                                 f"{started})")
        r = rec["roofline"]
        cells.append({
            "arch": arch, "shape": shape, "mesh": mesh,
            "status": rec["status"],
            "peak_gib": peak_bytes(rec["memory"]) / 2 ** 30,
            "fits_80gib": rec["fits_80gib"],
            "argument_parts": rec["memory"]["argument_parts"],
            "compute_ms": r["compute_s"] * 1e3,
            "memory_ms": r["memory_s"] * 1e3,
            "collective_ms": r["collective_s"] * 1e3,
            "dominant": r["dominant"], "trace_s": rec["trace_s"],
            "accum_steps": rec.get("accum_steps"),
            "opt_state_dtype": rec.get("opt_state_dtype"),
            "useful_flop_ratio": rec["useful_flop_ratio"],
            "wall_s": done[name][1]})
        c = cells[-1]
        kind = (f"accum {c['accum_steps']}, Adam {c['opt_state_dtype']}, "
                if shape == "train_4k" else
                f"state {c['argument_parts']['state'] / 2 ** 30:.3f} GiB, ")
        print(f"  {arch} {shape} {mesh}: {c['status']}, arguments + "
              f"temporaries {c['peak_gib']:.2f} GiB "
              f"({'fits' if c['fits_80gib'] else 'does not fit'} "
              f"{HBM_BYTES / 2 ** 30:.0f} GiB), compute {c['compute_ms']:.1f}"
              f" ms, memory {c['memory_ms']:.1f} ms, collective "
              f"{c['collective_ms']:.1f} ms, dominant {c['dominant']}, "
              f"{kind}useful FLOP ratio {c['useful_flop_ratio']:.3f}, "
              f"trace_s {c['trace_s']} (process {c['wall_s']:.1f} s)")
    for arch, shape in skipped:
        rec = run_cell(arch, shape, "single", save=False)
        if rec["status"] != "skipped":
            raise AssertionError(f"dry run {arch} {shape}: {rec['status']}")
        cells.append({"arch": arch, "shape": shape, "mesh": "single",
                      "status": "skipped"})
    print(f"  skipped as the reference skips them: "
          f"{', '.join(f'{a} {s}' for a, s in skipped)}")
    p14 = json.loads(done["phase14"][0].strip().splitlines()[-1])
    m = p14["memory"]
    peak = peak_bytes(m)
    ratio = peak / train["peak_bytes"]
    print(f"dry run of phase 14's cell ({TRAIN_ARCH}, {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}, bf16, remat, one-rank mesh): {p14['flops']:.0f} "
          f"FLOPs against phase 14's counted step "
          f"{train['step_flops']:.0f}; arguments {m['argument_size_in_bytes']}"
          f" + temporaries {m['temp_size_in_bytes']} = {peak / 2 ** 30:.2f} "
          f"GiB against phase 14's torch.cuda.max_memory_allocated "
          f"{train['peak_bytes'] / 2 ** 30:.2f} GiB: ratio {ratio:.4f} "
          f"(band {DRYRUN_PEAK_BAND}); trace {p14['trace_s']:.1f} s [{card}]")
    if p14["flops"] != train["step_flops"]:
        raise AssertionError(f"dry-run FLOPs {p14['flops']} != phase 14's "
                             f"{train['step_flops']}")
    if not DRYRUN_PEAK_BAND[0] <= ratio <= DRYRUN_PEAK_BAND[1]:
        raise AssertionError(f"dry-run peak {peak} is {ratio:.4f} of phase "
                             f"14's {train['peak_bytes']}")
    return {"cells": cells, "workers": workers,
            "phase14": {"flops": p14["flops"], "memory": m,
                        "measured_peak_bytes": train["peak_bytes"],
                        "peak_ratio": ratio, "trace_s": p14["trace_s"]}}


def serve_tp_plan(device_type: str = "cuda", small: bool = False) -> dict:
    """What phase 18 runs; ``small`` shrinks (a)-(c) to .reduced()
    configs at (d)'s shape, for a rehearsal on the CPU."""
    plan = dict(device_type=device_type, full=SERVE_TP_FULL,
                reduced=SERVE_TP_REDUCED, small=small)
    if small:
        B, S, T, _ = SERVE_TP_SMALL
        plan["full"] = tuple((a, m, B, S, T) for a, m, *_ in SERVE_TP_FULL)
        plan["reduced"] = SERVE_TP_REDUCED[:2]
    return plan


def serve_tp_cases(plan) -> list:
    """(label, config, mesh shape, batch, prompt, new tokens, frames,
    kv_quant, dtype) of every phase-18 case."""
    out = []
    for arch, mesh, B, S, T in plan["full"]:
        cfg = get_config(arch)
        out.append((f"{arch} {mesh[0]}x{mesh[1]}",
                    cfg.reduced() if plan["small"] else cfg, mesh, B, S, T,
                    0, False, torch.bfloat16))
    B, S, T, frames = SERVE_TP_SMALL
    for arch, quant in plan["reduced"]:
        cfg = get_config(arch).reduced()
        out.append((f"{arch} reduced{' int8' * quant} 2x2", cfg, (2, 2), B,
                    S, T, frames if cfg.family == "encdec" else 0, quant,
                    torch.float32))
    return out


def serve_tp_step(case, device, mesh=None):
    """A decode ``ServeStep`` of ``case`` on the card, on ``mesh`` or on
    none, its weights drawn from ``LM_SEED`` (leaf by leaf; with the
    mamba constants redrawn where the model has SSD blocks, from a whole
    tree)."""
    _, cfg, _, B, S, T, _, quant, dtype = case
    from repro_torch.launch.serve_step import ServeStep
    step = ServeStep(cfg, "decode", B, S + T, mesh=mesh, kv_quant=quant,
                     backend="cuda", device=device, compute_dtype=dtype)
    if cfg.ssm_state:
        tree = redraw_ssm_constants(Model(cfg, device=device).init_params(
            LM_SEED), LM_SEED + 1)
        step.load_params(tree)
        del tree
    else:
        step.load_params(seed=LM_SEED)
    return step


def serve_tp_inputs(case, device):
    """Seeded prompts (B, S) and encoder frames (B, frames, D) or None."""
    _, cfg, _, B, S, _, frames, _, _ = case
    prompts = torch.as_tensor(lm_prompts(cfg, B, S), device=device)
    enc = None
    if frames:
        enc = torch.randn(B, frames, cfg.d_model, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(LM_SEED))
    return prompts, enc


def serve_tp_drive(step, case, device, teacher=None) -> dict:
    """Init the state, prefill, then one decode step a new token, each fed
    ``teacher``'s token (the rank's rows of it), or greedily the argmax of
    the last logits without; every launch count set to 0 before the
    prefill and before the decode loop and read after each; host ms of
    each (synchronised).  Returns the logits (f32) and tokens as numpy
    arrays (a spawned rank's tensors would not outlive it)."""
    T = case[5]
    prompts, enc = serve_tp_inputs(case, device)
    step.init_state(None if enc is None else step.rows(enc))
    reset_launches()
    sync(device)
    t0 = time.perf_counter()
    logits = [step.prefill(step.rows(prompts))]
    sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_routes = dict(flash_forward.launches_by_route)
    prefill_counts = launch_counts()
    reset_launches()
    tokens = []
    t0 = time.perf_counter()
    for t in range(T):
        tok = logits[-1].argmax(-1, keepdim=True) if teacher is None \
            else step.rows(teacher[t])
        tokens.append(tok)
        logits.append(step.decode(tok))
    sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3 / T
    return {"logits": torch.stack([x.float().cpu() for x in logits])
            .numpy(),
            "tokens": np.stack([x.cpu().numpy() for x in tokens]),
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "prefill_routes": prefill_routes,
            "prefill_counts": prefill_counts,
            "decode_counts": launch_counts(),
            "rows": (step.first_row, step.rows_per_rank)}


def serve_tp_floors(step, case, device, want) -> dict:
    """How far the mesh-less bf16 ``step`` moves when only the order of
    its sums changes, in bf16 steps of the largest |logit| (the largest
    over the prefill's and the decode steps' logits), teacher-forced with
    its own greedy tokens ``want["tokens"]``: ``reduction``, run again
    with cuBLAS's reduced-precision reductions of bf16 products off;
    ``rows``, one prompt row at a time (the products' other row counts
    pick other GEMM tilings).  No launch of it is counted."""
    _, cfg, _, B, S, T, _, _, dtype = case
    teacher = torch.as_tensor(want["tokens"], device=device)
    x = want["logits"]

    def steps(got):
        return max(float(np.abs(g - w).max() / bf16_step(
            float(np.abs(w).max()))) for g, w in zip(got, x))
    mm = torch.backends.cuda.matmul
    flag = mm.allow_bf16_reduced_precision_reduction
    mm.allow_bf16_reduced_precision_reduction = False
    try:
        reduction = steps(serve_tp_drive(step, case, device, teacher)
                          ["logits"])
    finally:
        mm.allow_bf16_reduced_precision_reduction = flag
    from repro_torch.launch.serve_step import ServeStep
    one = ServeStep(cfg, "decode", 1, S + T, backend="cuda", device=device,
                    compute_dtype=dtype)
    one.load_params(step.params, sharded=True)
    rows = []
    for b in range(B):
        one.first_row = b                 # the rows a data-parallel rank takes
        rows.append(serve_tp_drive(one, case, device, teacher)["logits"])
    reset_launches()
    return {"reduction": reduction,
            "rows": steps(np.concatenate(rows, axis=1))}


def serve_tp_rank(rank, world, init, tmp, backend, plan, results) -> None:
    """One rank of phase 18: join the group, build the (2, 2) and (1, 4)
    meshes, and run every case against the mesh-less run's tokens
    (``tmp``); put its results (or its traceback) on ``results``."""
    import traceback
    try:
        if plan["device_type"] == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(
                                    seconds=DP_TIMEOUT_S))
        meshes = {shape: tp_mesh(shape, device, backend)
                  for shape in ((2, 2), (1, 4))}
        with np.load(os.path.join(tmp, "serve_teachers.npz")) as z:
            teachers = {k: z[k] for k in z.files}
        out = {}
        for case in serve_tp_cases(plan):
            t0 = time.perf_counter()
            step = serve_tp_step(case, device, meshes[case[2]])
            run = serve_tp_drive(step, case, device, torch.as_tensor(
                teachers[case[0]], device=device))
            run["param_bytes"] = tree_bytes(step.params)
            run["state_bytes"] = tree_bytes(
                {k: v for k, v in step.state.items() if k != "index"})
            run["wall_s"] = time.perf_counter() - t0
            out[case[0]] = run
            del step
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 — carried to the parent
        results.put((rank, False, traceback.format_exc()))


def serve_tp_path(device, card: str, plan=None) -> dict:
    """Phase 18: every case on the mesh-less ``ServeStep`` on the device
    (greedy), then on four gloo ranks teacher-forced with its tokens; the
    checks and the lines.  Raises on a bound missed or a launch count off:
    every attention case's prefill must launch ``flash_forward`` (route
    ``wgmma`` in bf16) once per attention layer on every rank, in "heads"
    and in "seq" mode, and no case's decode any kernel."""
    plan = plan or serve_tp_plan()
    cases = serve_tp_cases(plan)
    ref, teachers = {}, {}
    t0 = time.perf_counter()
    for case in cases:
        step = serve_tp_step(case, device)
        ref[case[0]] = serve_tp_drive(step, case, device)
        teachers[case[0]] = ref[case[0]]["tokens"]
        if case[8] == torch.bfloat16:
            ref[case[0]]["floors"] = serve_tp_floors(step, case, device,
                                                     ref[case[0]])
        del step
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out: dict = {"reference_s": time.perf_counter() - t0, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp:
        np.savez(os.path.join(tmp, "serve_teachers.npz"), **teachers)
        t0 = time.perf_counter()
        res = spawn_ranks(TP_RANKS, tmp, "gloo", plan, serve_tp_rank)
        out["ranks_s"] = time.perf_counter() - t0
    launches = 0
    for case in cases:
        label, cfg, _, B, S, T, _, quant, dtype = case
        want = ref[label]
        bf16 = dtype == torch.bfloat16
        errs, steps, agree = [], [], 0
        toks = teachers[label][..., 0]                       # (T, B)
        for r in res:
            got = r[label]
            first, n = got["rows"]
            w = want["logits"][:, first:first + n]
            errs.append([float(np.abs(g - x).max() / np.abs(x).max())
                         for g, x in zip(got["logits"], w)])
            steps.append([float(np.abs(g - x).max()
                                / bf16_step(float(np.abs(x).max())))
                          for g, x in zip(got["logits"], w)])
            agree += int((got["logits"][:-1].argmax(-1)
                          == toks[:, first:first + n]).sum())
        # each row is on max(mesh[1], 1) ranks: count it once
        agree //= case[2][1]
        pre = max(e[0] for e in errs)
        dec = max(max(e[1:]) for e in errs)
        pre_steps = max(e[0] for e in steps)
        dec_steps = max(max(e[1:]) for e in steps)
        if bf16:
            tol = f"{SERVE_BF16_STEPS} bf16 steps"
            bad = max(pre_steps, dec_steps) > SERVE_BF16_STEPS
        else:
            tol = f"{SERVE_PREFILL_REL:.3g}, {SERVE_DECODE_REL:.3g}"
            bad = pre > SERVE_PREFILL_REL or dec > SERVE_DECODE_REL
        if bad:
            raise AssertionError(f"sharded serving {label}: prefill logits "
                                 f"rel {pre} ({pre_steps} bf16 steps), "
                                 f"decode {dec} ({dec_steps}); tol {tol}")
        meta = Model(cfg, device="meta")
        # the prefill: one flash launch per self- and cross-attention layer
        # in either mode ("heads": the rank's heads; "seq": its query chunk
        # at its offset), the encoder's run in init_state, before the
        # count; no other kernel, and none in decode
        heads = cfg.n_heads % case[2][1] == 0
        layers = meta.mixer_counts()[0] * meta.n_units \
            * (1 + (cfg.family == "encdec"))
        want_flash = layers if device.type == "cuda" else 0
        for rank, r in enumerate(res):
            got = r[label]
            pc, dc = got["prefill_counts"], got["decode_counts"]
            if pc["flash"] != want_flash or any(
                    v for k, v in pc.items() if k != "flash") or \
                    any(dc.values()):
                raise AssertionError(f"sharded serving {label} rank {rank}"
                                     f": prefill launches {pc}, decode "
                                     f"{dc}; want {want_flash} flash")
            if bf16 and got["prefill_routes"]["wgmma"] != want_flash:
                raise AssertionError(f"{label} rank {rank}: routes "
                                     f"{got['prefill_routes']}")
            launches += pc["flash"]
        out["cases"][label] = {
            "prefill_rel": pre, "decode_rel": dec,
            "prefill_bf16_steps": pre_steps, "decode_bf16_steps": dec_steps,
            "tol": tol, "floors": want.get("floors"),
            "greedy_agree": agree, "greedy_of": B * T,
            "routes": [r[label]["prefill_routes"] for r in res],
            "prefill_ms": [r[label]["prefill_ms"] for r in res],
            "decode_ms": [r[label]["decode_ms"] for r in res],
            "meshless_prefill_ms": want["prefill_ms"],
            "meshless_decode_ms": want["decode_ms"],
            "param_bytes": [r[label]["param_bytes"] for r in res],
            "state_bytes": [r[label]["state_bytes"] for r in res],
            "wall_s": res[0][label]["wall_s"], "attention_layers": layers,
            "mode": "heads" if heads else "seq"}
        c = out["cases"][label]
        floor = "" if c["floors"] is None else (
            f" (the mesh-less step against itself: reduced-precision "
            f"reductions off {c['floors']['reduction']:.2f} steps, one row "
            f"at a time {c['floors']['rows']:.2f})")
        print(f"sharded serving {label}: {cfg.name} ({cfg.param_count()} "
              f"params, {str(dtype).split('.')[-1]}"
              f"{', int8 cache' if quant else ''}), {B} x {S} prompts then "
              f"{T} tokens on ServeStep(mesh=) over gloo: prefill logits "
              f"max|diff| / max|logit| {pre:.3g} ({pre_steps:.2f} bf16 steps "
              f"of the largest), decode {dec:.3g} ({dec_steps:.2f}); tol "
              f"{tol} against the mesh-less step{floor}; greedy tokens "
              f"agreeing {agree} of {B * T}; \"{c['mode']}\" attention: "
              f"flash_forward launches by route per rank in the prefill "
              f"{c['routes']} for {layers} attention layers (decode: "
              f"none); {c['wall_s']:.1f} s [{card}]")
        print(f"  per rank: stored bf16/f32 weights {c['param_bytes']} B, "
              f"state {c['state_bytes']} B; prefill ms "
              f"{[round(x, 1) for x in c['prefill_ms']]}, decode ms per "
              f"token {[round(x, 2) for x in c['decode_ms']]} (gloo stages "
              f"every exchange through host memory: no speed conclusion); "
              f"mesh-less on the card: prefill {c['meshless_prefill_ms']:.1f}"
              f" ms, decode {c['meshless_decode_ms']:.2f} ms per token "
              f"[{card}]")
    out["launches"] = launches
    return out


def seq_rank_shape() -> tuple:
    """(B, Sq, Sk, H, K, hd, q_offset) of one rank's "seq" attention in
    phase 18's smollm-360m case on (2, 2): its batch shard, its query
    chunk (the second: offset Sq) over the gathered sequence."""
    arch, mesh, B, S, _ = SERVE_TP_FULL[1]
    cfg = get_config(arch)
    Sq = S // mesh[1]
    return (B // mesh[0], Sq, S, cfg.n_heads, cfg.n_kv, cfg.head_dim, Sq)


def serve_flash_shape(device, card: str) -> dict:
    """``flash_forward`` at (a)'s per-rank prefill shape: phi3-mini's 8 of
    32 heads at hd 96, 4 x 1024, causal, bf16 (B·H/m = 32 head rows):
    against its plain version, then timed beside SDPA."""
    arch, mesh, B, S, _ = SERVE_TP_FULL[0]
    cfg = get_config(arch)
    H = cfg.n_heads // mesh[1]
    K = cfg.n_kv // mesh[1]
    err = compare_flash(B, S, S, H, K, cfg.head_dim, True, torch.bfloat16,
                        device, steps=FLASH_BF16_STEPS)
    t = flash_timing(B, S, S, H, K, cfg.head_dim, True, SERVE_FLASH_REPS,
                     device)
    print(f"flash_forward at phase 18's per-rank shape ({arch} on "
          f"{mesh[0]}x{mesh[1]}: B {B}, S {S}, {H}/{K} heads, hd "
          f"{cfg.head_dim}, causal, bf16): max|diff| vs plain {err:.3g}; "
          f"{t['ms']:.4f} ms eager, {t['device_ms']:.4f} ms device (graph "
          f"replay); SDPA ({t['lib_form']}) {t['lib_ms']:.4f} ms eager, "
          f"{t['lib_device_ms']:.4f} ms device; plain {t['plain_ms']:.3f} "
          f"ms; bound {t['bound_ms']:.5f} ms by {t['bound_by']} [{card}]")
    return dict(t, max_abs_err=err, shape=[B, S, S, H, K, cfg.head_dim])


def load_example(name: str):
    """``examples/<name>.py`` of this checkout as a module."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_routes() -> dict:
    """Every kernel wrapper's launches by route, keyed as
    ``launch_counts``."""
    routes = tile_routes()
    routes["cascade"] = dict(cascade_qs_forward.launches_by_route)
    routes["flash"] = dict(flash_forward.launches_by_route)
    return routes


def examples_path(device, card: str) -> dict:
    """Phase 19: each of ``EXAMPLES`` through its ``main`` in this process
    at the reference's default sizes (its own assertions are the checks;
    the LM example checkpoints into a temporary directory), the serving
    example a second time, which must answer from the autotuner's cache
    file (``REPRO_ENGINE_CACHE`` in the temporary directory; the memory
    cache cleared before each run) with the first run's engine, batches
    and accuracy.  Every launch count is set to 0 just before each run and
    read just after: the quickstart launches ``qs_forward`` (its kernel
    step), the first serving run's sweep all three forest kernels, and the
    ranking and training examples no kernel (``backend="torch"``).
    Returns per run its seconds, returned numbers, launches and routes."""
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        runs = [(name, ["--ckpt-dir", os.path.join(tmp, "train_lm")]
                 if name == "torch_train_lm" else []) for name in EXAMPLES]
        runs.insert(2, ("torch_serve_forest", []))
        cache_env = os.environ.get("REPRO_ENGINE_CACHE")
        os.environ["REPRO_ENGINE_CACHE"] = os.path.join(tmp, "cache.json")
        try:
            for name, argv in runs:
                label = name if name not in out else f"{name} (again)"
                mod = load_example(name)
                engine_select.clear_cache()
                gc.collect()
                sync(device)
                reset_launches()
                t0 = time.perf_counter()
                ret = mod.main(argv)
                sync(device)
                out[label] = {"s": time.perf_counter() - t0,
                              "returned": ret, "launches": launch_counts(),
                              "routes": kernel_routes(),
                              "transform_launches": transform_launches()}
                print(f"example {label}: {out[label]['s']:.1f} s, kernel "
                      f"launches {out[label]['launches']} by route "
                      f"{out[label]['routes']} [{card}]")
                if device.type == "cuda":
                    torch.cuda.empty_cache()
        finally:
            if cache_env is None:
                os.environ.pop("REPRO_ENGINE_CACHE", None)
            else:
                os.environ["REPRO_ENGINE_CACHE"] = cache_env
    engines = [k.engine for k in KERNELS]

    def launched(label):
        return {k: v for k, v in out[label]["launches"].items() if v}

    first, again = (out[n] for n in ("torch_serve_forest",
                                     "torch_serve_forest (again)"))
    # on the card; on the CPU (a rehearsal) nothing launches and the
    # sweep holds the six torch engines
    if device.type == "cuda":
        quick = launched("torch_quickstart")
        if set(quick) != {"bitvector"}:
            raise AssertionError(f"quickstart launched {quick}: want "
                                 f"qs_forward alone")
        swept = launched("torch_serve_forest")
        if set(swept) != set(engines):
            raise AssertionError(f"the serving example's sweep launched "
                                 f"{swept}: want every forest kernel")
        want_tune = {"cuda-qs", "cuda-bitmm", "cuda-gemm"}
        if not want_tune <= set(first["returned"]["candidates"]) or \
                len(first["returned"]["candidates"]) != 9:
            raise AssertionError(f"swept "
                                 f"{first['returned']['candidates']}")
    r1, r2 = first["returned"], again["returned"]
    if r1["from_cache"] or not r2["from_cache"] or \
            r1["engine"] != r2["engine"] or any(
                r1[k] != r2[k] for k in ("n_batches", "accuracy", "served")):
        raise AssertionError(f"the second serving run: {r2}, the first "
                             f"{r1}")
    for label in ("torch_ranking_e2e", "torch_train_lm",
                  "torch_elastic_restart"):
        if launched(label):
            raise AssertionError(f"{label} launched {launched(label)}")
    for label, run in out.items():
        check_routes({k: run["routes"][k] for k in engines},
                     run["launches"], label)
    return out


def sharded_path(qforest, forest, rows, kernel_out, device,
                 counts=SHARD_COUNTS, reps=SHARD_REPS) -> dict:
    """Tree-sharded execution of every shardable torch engine over
    ``devices=[device] * D`` for D in ``counts``.  Every launch count is
    set to 0 just before the sharded predictions and read just after: the
    torch engines launch no kernel.  On the int16 forest each output must
    equal the unsharded engine's and ``kernel_out`` (the ``qs_forward``
    predictor's) bit for bit; on the float forest, the unsharded engine's
    within the full-width tolerance.  Host-clock ms of ``predict``
    (median of ``reps``; its numpy result ends the call), unsharded and
    at each D; the two ``ValueError``s of ``n_devices > 1`` on one card."""
    engines = [s.name for s in core.registry.specs("torch") if s.shardable]
    unsharded, ms = {}, {}
    for engine in engines:
        pred = core.compile_forest(qforest, engine=engine, backend="torch",
                                   device=device)
        unsharded[engine] = pred.predict(rows)
        if not np.array_equal(unsharded[engine], kernel_out):
            raise AssertionError(f"{engine}: unsharded torch engine differs "
                                 "from the qs_forward predictor")
        ms[engine, 0] = host_ms(lambda: pred.predict(rows), reps)
    reset_launches()
    preds = {}
    for engine in engines:
        for D in counts:
            p = preds[engine, D] = shard.tree_sharded(
                qforest, engine, devices=[device] * D)
            got = p.predict(rows)
            if not np.array_equal(got, unsharded[engine]) or \
                    not np.array_equal(got, kernel_out):
                raise AssertionError(f"{engine} sharded D={D}: int16 output "
                                     "differs from one device's")
    launched = launch_counts()
    if any(launched.values()):
        raise AssertionError(f"sharded torch engines launched {launched}")
    for (engine, D), p in preds.items():
        ms[engine, D] = host_ms(lambda: p.predict(rows), reps)
    worst = 0.0
    for engine in engines:
        want = core.compile_forest(forest, engine=engine, backend="torch",
                                   device=device).predict(rows)
        for D in counts:
            got = shard.tree_sharded(forest, engine,
                                     devices=[device] * D).predict(rows)
            if not np.allclose(got, want, rtol=RTOL, atol=ATOL_FULL):
                raise AssertionError(f"{engine} sharded D={D}: float output "
                                     f"max|diff| {np.abs(got - want).max()}")
            worst = max(worst, float(np.abs(got - want).max()))
    errors = {}
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    for backend in ("torch", "cuda"):
        try:
            core.compile_plan(qforest, engine="bitvector", backend=backend,
                              device=device, n_devices=visible + 1)
        except ValueError as e:
            errors[backend] = str(e)
    if device.type == "cuda" and ("devices visible" not in
                                  errors.get("torch", "") or
                                  "torch backend only" not in
                                  errors.get("cuda", "")):
        raise AssertionError(f"n_devices={visible + 1} on the card: {errors}")
    return dict(engines=engines, ms=ms, float_err=worst, errors=errors,
                launches=launched)


def host_ms(fn, reps: int) -> float:
    """Median host-clock ms of ``fn()`` over ``reps`` calls, after one."""
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(out))


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
    sources = [k.source_name for k in KERNELS] + [
        "cascade_qs_forward", "flash_forward", "quantize_rows"]
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

    # the input transform at the cells' shapes
    qc = quantize_check(msn, full, qfull, device)
    msn_rows, magic_rows, mforest = qc["msn_rows"], qc["magic_rows"], \
        qc["mforest"]
    print(f"quantize_rows: {qc['n_cases']} shapes (MSN "
          f"{QUANTIZE_MSN[0][0]}x{d} and {len(QUANTIZE_MSN) - 1} query "
          f"buckets 128-1024 on the int16 grid, magic {MAGIC_ROWS}x"
          f"{magic_rows.shape[1]}, the int8 grid at 8192 and 100 rows, a "
          f"feat_map over {d + 14} columns) x f32/f64 callers, with NaN "
          f"rows, ±inf, -0.0, lo, hi and grid edges ±1 ulp, and mnist "
          f"{MNIST_ROWS}x784 uint8 rows through InputGrid.feed with rows "
          f"of 0 and 255, lo, hi and the pixels either side of grid edges: "
          f"bit-identical to the plain torch version and to "
          f"quantize_inputs(...).astype(float32), padding +0.0; "
          f"{qc['launches']} launches")

    # 4. the main path at full width through each engine, then a trained
    # model's accuracy
    rows = np.concatenate([msn.X_test, msn.X_train])[:N_REQUESTS]
    launches, served, msn_preds, servers = {}, {}, {}, {}
    for k in KERNELS:
        t0 = time.perf_counter()
        pred, served[k.engine], server, launches[k.engine] = main_path(
            full, msn.X_train, rows, device, engine=k.engine)
        msn_preds[k.engine], servers[k.engine] = pred, server
        wall = time.perf_counter() - t0
        stats = server.stats.summary()
        print(f"main path: {pred.plan.describe()}")
        print(f"{k.engine}: served {stats['n_requests']} requests in "
              f"{stats['n_batches']} batches (mean {stats['mean_batch']:.1f} "
              f"rows), {k.source_name} launches {launches[k.engine]}, "
              f"quantize_rows as many; served == predict; {wall:.2f} s host "
              f"wall incl. quantize+compile")
        print(f"{k.engine} per batch, host clock: predict (copy in, "
              f"quantize_rows, kernel, copy out) p50 "
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
          f"with survivors); quantize_rows launches "
          f"{casc['transform_launches']}; tier-2 fused == staged == "
          f"tier-1 bitmm == "
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
    split = host_split(casc["fused"], crows[:round(casc["mean_batch"])])
    children = sum(v for k, v in split.items()
                   if k != "bucket" and "." not in k)
    print(f"one served fused mnist batch of {round(casc['mean_batch'])} rows "
          f"(bucket {split['bucket']}), the program's spans, median of 20: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()
                      if k != "bucket")
          + f"; sum of the root's children {children:.3f} ms [{card}]")

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

    # 7. the autotuner on the card: the MSN forest swept, the decision
    # replayed by a second process, served by from_forest, the mnist
    # cascade's candidates, and the -Os cost model
    old_registry = set_default_registry(MetricsRegistry())
    # phase 9 asks phase 7's cache file again
    runtime_dir = tempfile.TemporaryDirectory()
    kept_cache = os.path.join(runtime_dir.name, "engine_cache.json")
    try:
        with tempfile.TemporaryDirectory() as tmpdir:
            t_tune = time.perf_counter()
            cache = os.path.join(tmpdir, "engine_cache.json")
            sw = autotune_sweep(qfull, rows, device, cache)
            choice = sw["choice"]
            ranked = sorted(choice.timings, key=choice.timings.get)
            margin = choice.timings[ranked[1]] / choice.timings[ranked[0]]
            print(f"autotune: MSN int16 forest T={T} L={L} d={d} at batch "
                  f"{MAX_BATCH}, key {choice.key}: {len(choice.timings)} "
                  f"candidates ({len(choice.pruned)} aliased as identical "
                  f"IR) in {sw['wall']:.1f} s host wall; winner "
                  f"{choice.engine}, {margin:.3f}x faster than {ranked[1]}"
                  f"; kernel launches in the sweep "
                  f"{sw['launches']}; winner == plain torch on {len(rows)} "
                  f"rows, bit for bit")
            for name in ranked:
                print(f"autotune candidate {name}: bench_us "
                      f"{choice.timings[name] / MAX_BATCH * 1e6:.5f} per row "
                      f"({choice.timings[name] * 1e3:.4f} ms per batch, host "
                      f"clock around predict), compile_s "
                      f"{choice.compile_s[name]:.3f} [{card}]")
            t0 = time.perf_counter()
            child = autotune_second_process(qfull, device, cache, tmpdir)
            if child != {"from_cache": True, "engine": choice.engine,
                         "sweeps": 0.0}:
                raise AssertionError(f"second process: {child}")
            print(f"autotune: a second process loaded the forest from "
                  f"io.save_forest's file and asked the same cache: "
                  f"{child} ({time.perf_counter() - t0:.1f} s with its "
                  f"start)")
            t0 = time.perf_counter()
            srv = autotune_server(qfull, rows, served["bitvector"], device,
                                  cache)
            print(f"autotune: ForestServer.from_forest(max_batch="
                  f"{MAX_BATCH}) from the cache: "
                  f"{srv['server'].engine_choice.engine} (of the 9 "
                  f"candidates as-is), served {len(rows)} rows in "
                  f"{srv['n_batches']} batches, launches {srv['launches']}, "
                  f"== phase 4 bit for bit; compile_forest(tune='measure') "
                  f"built the same engine with no sweep "
                  f"({time.perf_counter() - t0:.1f} s)")
            t0 = time.perf_counter()
            ct = autotune_cascade(casc["qforest"], casc["stages"],
                                  casc["policy"], crows, casc["served"],
                                  casc["full"], device, cache)
            cchoice = ct["choice"]
            exits = {k: [round(float(x), 4) for x in v]
                     for k, v in ct["exits"].items()}
            print(f"autotune: mnist cascade forest, engines "
                  f"{CASCADE_TUNE_ENGINES} x (as-is, staged, fused) with "
                  f"{casc['policy'].tag()} at batch {MAX_BATCH}: winner "
                  f"{cchoice.engine}; launches in the sweep {ct['launches']}"
                  f"; served {N_REQUESTS} rows == phase 5 bit for bit, "
                  f"launches {ct['served_launches']}; the fused "
                  f"candidate's exit fractions per stage on the sweep's "
                  f"N(0, 1) rows {exits['sweep']}, on the served rows "
                  f"{exits['served']} ({time.perf_counter() - t0:.1f} s)")
            for name in sorted(cchoice.timings, key=cchoice.timings.get):
                print(f"autotune cascade candidate {name}: bench_us "
                      f"{cchoice.timings[name] / MAX_BATCH * 1e6:.5f} per "
                      f"row, compile_s {cchoice.compile_s[name]:.3f} "
                      f"[{card}]")
            t0 = time.perf_counter()
            pr = autotune_predict(device, cache,
                                  os.path.join(tmpdir, "cost_model.json"))
            for shape, c in pr["sweeps"]:
                order = sorted(c.timings, key=c.timings.get)
                print(f"autotune ladder T,L,d,C={shape} batch "
                      f"{PREDICT_BATCH}: winner {order[0]} "
                      f"({c.timings[order[1]] / c.timings[order[0]]:.3f}x "
                      f"{order[1]}); us per row " + ", ".join(
                          f"{n} {c.timings[n] / PREDICT_BATCH * 1e6:.4f}"
                          for n in order) + f" [{card}]")
            m = pr["model"]
            print(f"autotune -Os: cost model fit on {m.n_rows} rows of the "
                  f"cache, residual sigma {m.resid_sigma:.4f} (log us)")
            for shape, thr, c, rel in pr["asked"]:
                print(f"autotune -Os T,L,d,C={shape} batch {PREDICT_BATCH} "
                      f"threshold {thr}: predicted {c.predicted}, confidence "
                      f"{c.confidence:.4f}, winner {c.engine}, "
                      f"repro_autotune_predict_rel_error {rel}; winner == "
                      f"plain torch bit for bit [{card}]")
            print(f"autotune phase: {time.perf_counter() - t_tune:.1f} s "
                  f"(-Os part {time.perf_counter() - t0:.1f} s)")
            with open(cache) as src, open(kept_cache, "w") as dst:
                dst.write(src.read())
    finally:
        set_default_registry(old_registry)

    # 8. the LM slice: flash_forward against its plain version, then
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
    # the sharded prefill's "seq" attention on a rank: each of the two
    # query chunks of phase 18's smollm-360m on (2, 2) at its offset
    B_, Sq, Sk, H_, K_, hd_, off = seq_rank_shape()
    seq_err = {(dt, o): compare_flash(B_, Sq, Sk, H_, K_, hd_, True, dt,
                                      device, q_offset=o)
               for dt in worst for o in (0, off)}
    print(f"flash_forward with a query offset, at phase 18's \"seq\" rank "
          f"shape (B {B_}, {Sq} queries over {Sk} keys, {H_}/{K_} heads, hd "
          f"{hd_}, causal) at offsets 0 and {off}: max|diff| vs plain f32 "
          f"{max(seq_err[torch.float32, o] for o in (0, off)):.3g} (tol "
          f"{FLASH_TOL_F32}), bf16 "
          f"{max(seq_err[torch.bfloat16, o] for o in (0, off)):.3g} (tol "
          f"{FLASH_TOL_BF16}); two launches bit-identical")
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

    # 9. the serving runtime: the four-tenant fleet under open-loop
    # traffic with a live scrape, from_forests from phase 7's cache, a
    # fleet saved and loaded onto the card, and the serve launcher
    t_rt = time.perf_counter()
    with runtime_dir:
        fl = runtime_fleet(msn_preds, casc["fused"], rows, served["bitvector"],
                           crows, casc["exit_counts"], device)
        for tid, s in fl["summary"].items():
            ph = fl["phases"][tid]
            ctl = s.get("controller")
            print(f"runtime tenant {tid}: {s['n_requests']} requests in "
                  f"{s['n_batches']} batches (mean {s['mean_batch']:.1f} "
                  f"rows), latency p50 {s['p50_ms']:.3f} ms p99 "
                  f"{s['p99_ms']:.3f} ms (unthrottled run p50 "
                  f"{fl['free'][tid][0]:.3f} p99 {fl['free'][tid][1]:.3f});"
                  f" mean per phase, ms: "
                  + ", ".join(f"{p} {v:.4f}" for p, v in ph.items())
                  + " (unthrottled run: " + ", ".join(
                      f"{p} {v:.4f}" for p, v in
                      fl["free_phases"][tid].items()) + ")"
                  + (f"; controller target p99 {ctl['target_p99_ms']:.3f} "
                     f"ms, {ctl['n_decisions']} decisions {ctl['actions']}"
                     f", effective max_batch {s['effective_max_batch']} "
                     f"max_wait_ms {s['effective_max_wait_ms']:.4f}"
                     if ctl else "") + f" [{card}]")
        print(f"runtime fleet: {fl['n_requests']} requests (4096 MSN rows "
              f"over {', '.join(MSN_TENANTS)}, 4096 mnist rows to "
              f"{MNIST_TENANT}) at {RUNTIME_RATE_HZ:.0f} req/s offered "
              f"(Poisson, real clock), served in {fl['wall']:.3f} s: "
              f"{fl['n_requests'] / fl['wall']:.1f} req/s; launches "
              f"{fl['launches']} (one per batch, smem_x route, no other "
              f"kernel); served == predict bit for bit, MSN == phase 4, "
              f"cascade exits == phase 5 {casc['exit_counts']}; "
              f"compile events and retrace anomalies 0 after warmup; "
              f"{len(fl['scrapes'])} concurrent scrapes of /metrics and "
              f"/traces (ms each, both endpoints: mean "
              f"{np.mean(fl['scrapes']):.2f}, max {max(fl['scrapes']):.2f}"
              f"; the unthrottled run had none and took "
              f"{fl['free_wall']:.3f} s), the last lists all "
              f"{len(METRIC_CATALOG)} catalog metrics "
              f"({fl['n_series']} series) with the counters of stats() "
              f"[{card}]")
        print("runtime fleet, p99 latency ms of each tenth of the requests "
              "in arrival order: unthrottled run "
              + ", ".join(f"{v:.2f}" for v in fl["deciles"][0])
              + "; served run " + ", ".join(f"{v:.2f}" for v in
                                           fl["deciles"][1])
              + "; compute_ms of each tenant's first batch / its largest: "
              "unthrottled " + ", ".join(
                  f"{t} {a:.3f}/{b:.3f}" for t, (a, b) in
                  fl["first"][0].items())
              + "; served " + ", ".join(
                  f"{t} {a:.3f}/{b:.3f}" for t, (a, b) in
                  fl["first"][1].items()) + f" [{card}]")
        ff = runtime_from_forests(qfull, rows, served["bitvector"], device,
                                  kept_cache)
        print(f"runtime from_forests: the MSN forest with phase 7's cache "
              f"and engines → {ff['engine']}, from the cache, "
              f"{ff['sweeps']:.0f} sweeps; served {len(rows)} rows in "
              f"{ff['n_batches']} batches == phase 4 bit for bit")
        trip = runtime_round_trip(qfull, casc["qforest"], casc["stages"],
                                  casc["policy"], rows, crows,
                                  served["bitvector"], casc["served"],
                                  device, runtime_dir.name)
        print(f"runtime save/load: fleet {trip['tenants']} (torch engines) "
              f"saved ({trip['bytes']} bytes) and loaded onto the card in "
              f"{trip['load_ms']:.1f} ms, serves == phases 4 and 5 bit for "
              f"bit; saving a cuda tenant raises ValueError "
              f"({trip['cuda_error'][:60]}...) [{card}]")
    launcher = launcher_modes(device)
    print("runtime launcher: python -m repro_torch.launch.serve in process: "
          + "; ".join(
              f"--mode {m} launches {r['launches']} "
              f"({'flash_forward' if m == 'lm' else 'qs_forward'})"
              for m, r in launcher.items())
          + f"; runtime mode p99 {launcher['runtime']['result']['p99_ms']:.3f}"
          f" ms, accuracy {launcher['runtime']['result']['accuracy']:.4f}"
          f" [{card}]")
    print(f"runtime phase: {time.perf_counter() - t_rt:.1f} s [{card}]")

    # 10. tree-sharded execution of phase 4's MSN int16 forest over D
    # shards on the one card
    t0 = time.perf_counter()
    kernel_out = msn_preds["bitvector"].predict(rows_full)
    sh = sharded_path(qfull, full, rows_full, kernel_out, device)
    print(f"sharded: {', '.join(sh['engines'])} tree-sharded over "
          f"devices=[cuda:0]*D for D in {SHARD_COUNTS} at T={T} L={L} "
          f"d={d} B={B}: int16 == unsharded torch engine == qs_forward "
          f"predictor bit for bit; float max|diff| {sh['float_err']:.3g} "
          f"(atol {ATOL_FULL}); kernel launches in the sharded run "
          f"{sh['launches']}; n_devices=2 on one card raises: torch "
          f"{sh['errors']['torch']!r}; cuda {sh['errors']['cuda']!r}")
    for engine in sh["engines"]:
        t = sh["ms"]
        print(f"sharded {engine} predict, host clock, median of "
              f"{SHARD_REPS}: unsharded {t[engine, 0]:.3f} ms, "
              + ", ".join(f"D={D} {t[engine, D]:.3f} ms"
                          for D in SHARD_COUNTS) + f" [{card}]")
    print(f"sharded phase: {time.perf_counter() - t0:.1f} s [{card}]")

    # 11. the moe, ssm and hybrid LM families served as phase 8 serves
    # smollm-360m
    family_launches = {}
    for name, spec in LM_FAMILIES.items():
        t0 = time.perf_counter()
        fcfg, fam = lm_family_path(name, spec, device)
        family_launches[fcfg.name] = fam["launches"]
        Bf, Sf, nf = spec["batch"], spec["prompt"], spec["new"]
        tf = fam["times"]
        cut = (" (.reduced())" if spec["reduced"] else
               f" (depth cut to {spec['layers']} layers)" if spec["layers"]
               else " (published size)")
        print(f"LM family {fcfg.name}{cut}: {fcfg.family}, {fcfg.n_layers} "
              f"layers d={fcfg.d_model} experts {fcfg.n_experts} "
              f"(top-{fcfg.top_k}) ssm state {fcfg.ssm_state} headdim "
              f"{fcfg.ssm_headdim} vocab {fcfg.vocab}, "
              f"{fcfg.param_count()} params; LMServer(batch={Bf}, max_len="
              f"{Sf + nf + 1}).generate({Bf}x{Sf}, n_new={nf}) in bf16 on "
              f"backend=cuda: flash_forward launches {fam['launches']} for "
              f"{fam['n_attn']} attention layers (routes {fam['routes']}), "
              f"no other kernel; {time.perf_counter() - t0:.1f} s host wall")
        print(f"LM family {fcfg.name} checks: f32 greedy tokens cuda == "
              f"torch; prefill logits cuda vs torch max|diff| / max|logit|:"
              f" f32 {fam['err32']:.3g} (tol {LM_LOGIT_TOL_F32}), bf16 "
              f"{fam['err16']:.3g} (tol {LM_LOGIT_TOL_BF16}); bf16 cuda vs "
              f"f32 torch {fam['err16_vs32']:.3g}; MoE routes differing "
              f"cuda vs torch (of all): f32 {fam['flips'][torch.float32]}, "
              f"bf16 {fam['flips'][torch.bfloat16]}; teacher-forced decode "
              f"vs forward ({fam['steps']} steps, f32) max|diff| "
              f"{fam['dec_err']:.3g} (tol {LM_DECODE_TOL})")
        print(f"LM family {fcfg.name} served (bf16, host clock around "
              f"synchronised calls, second call): prefill "
              f"{tf['prefill_ms']:.2f} ms, decode "
              f"{tf['decode_ms'] / nf:.3f} ms per token; first call "
              f"prefill {fam['times_cold']['prefill_ms']:.2f} ms, decode "
              f"{fam['times_cold']['decode_ms'] / nf:.3f} ms per token "
              f"[{card}]")
        del fam

    # 12. timings at the main paths' full-width kernel shapes.  ms and
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
            "runtime_launches": fl["launches"][k.engine],
            "max_abs_err": full_err[k.engine], "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "library_device_ms": None})
    qt = {"msn_bulk": quantize_timing(qfull, msn_rows, device),
          "magic_cascade": quantize_timing(mforest, magic_rows, device)}
    for name, t in qt.items():
        print(f"quantize_rows {name} {t['shape'][0]}x{t['shape'][1]} f32 "
              f"rows: kernel {t['ms']:.4f} ms (eager loop; on the device by "
              f"graph replay {t['device_ms']:.4f} ms), plain torch "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms by "
              f"bytes ({t['nbytes']} bytes) [{card}]")
    t = qt["msn_bulk"]
    records.append({
        "name": "quantize_rows", "route": "cuda",
        "source": quantize_rows.source, "replaces": quantize_rows.replaces,
        "launches": sum(s.stats.n_batches for s in servers.values()),
        "runtime_launches": fl["transform_launches"], "max_abs_err": 0.0,
        "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None,
        "library_device_ms": None, "shapes": {"magic_cascade": {
            k: v for k, v in qt["magic_cascade"].items()
            if k != "nbytes"}}})

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
        "runtime_launches": fl["launches"]["cascade"],
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

    # flash_forward at the LM paths' shapes: smollm-360m's served prefill
    # and prefill_32k's per-sequence shape (causal GQA); seamless's encoder
    # self-attention (Sq = Sk, non-causal), its decoder's causal
    # self-attention over the 16 prompt tokens, and its cross-attention
    # (16 queries over 1024 frames, non-causal MHA).  The served prefill
    # reads each layer's cross K/V long after init_decode_state made them,
    # so the cross shape is timed with cold L2; "cross64" is the same
    # K/V under 64 queries, one whole wgmma query tile, to price the 48
    # masked rows of Sq = 16.  "seq_rank" is phase 18's smollm-360m "seq"
    # attention on one rank of (2, 2): its 256-row query chunk at offset
    # 256 over the gathered 512 keys.  The last field is the query offset
    ecfg = get_config(ENCDEC_ARCH)
    frames = enc_len(ecfg, ENCDEC_SEQ)
    seq = seq_rank_shape()
    flash_shapes = {
        "served": (LM_BATCH, LM_PROMPT, LM_PROMPT, H, K, hd, True, 50, 0),
        "32k": (1, LONG_S, LONG_S, H, K, hd, True, 3, 0),
        "encoder": (ENCDEC_BATCH, frames, frames, ecfg.n_heads, ecfg.n_kv,
                    ecfg.head_dim, False, 50, 0),
        "decoder": (ENCDEC_BATCH, ENCDEC_PROMPT, ENCDEC_PROMPT,
                    ecfg.n_heads, ecfg.n_kv, ecfg.head_dim, True, 200, 0),
        "cross": (ENCDEC_BATCH, ENCDEC_PROMPT, frames, ecfg.n_heads,
                  ecfg.n_heads, ecfg.head_dim, False, 200, 0),
        "cross64": (ENCDEC_BATCH, 64, frames, ecfg.n_heads, ecfg.n_heads,
                    ecfg.head_dim, False, 200, 0),
        "seq_rank": (*seq[:6], True, 50, seq[6]),
    }
    flash_ms = {}
    for name, (B_, Sq, Sk, H_, K_, hd_, causal, reps, off) in \
            flash_shapes.items():
        cold = name.startswith("cross")
        t = flash_ms[name] = flash_timing(B_, Sq, Sk, H_, K_, hd_, causal,
                                          reps, device, plain=name != "32k",
                                          cold=cold, q_offset=off)
        how = (f"with cold L2, turning over {t['n_sets']} input sets"
               if cold else "L2-warm")
        warm = (f"; L2-warm aside: kernel {t['warm_device_ms']:.4f} ms, SDPA "
                f"{t['lib_warm_device_ms']:.4f} ms on the device"
                if cold else "")
        sdpa = (f"K/V[:{off + Sq}], causal_lower_right" if off
                else f"is_causal={causal}")
        print(f"flash_forward {name} B={B_} H={H_}/{K_} Sq={Sq} Sk={Sk} "
              f"q_offset={off} hd={hd_} bf16 "
              f"{'causal' if causal else 'non-causal'}, "
              f"{how}: kernel {t['ms']:.4f} ms (eager loop; on the device "
              f"by graph replay {t['device_ms']:.4f} ms), plain torch "
              + ("not timed" if t["plain_ms"] is None
                 else f"{t['plain_ms']:.4f} ms")
              + f", scaled_dot_product_attention ({sdpa}, "
              f"{t['lib_form']}) {t['lib_ms']:.4f} ms (on the device "
              f"{t['lib_device_ms']:.4f} ms; max|diff| vs kernel "
              f"{t['lib_err']:.3g}), bound {t['bound_ms']:.5f} ms by "
              f"{t['bound_by']} ({t['nbytes']} bytes, {t['n_ops']} ops); "
              f"kernel {t['n_ops'] / t['ms'] / 1e9:.2f} TFLOP/s{warm} "
              f"[{card}]")
    c16, c64 = (flash_ms[n]["device_ms"] for n in ("cross", "cross64"))
    print(f"flash_forward cross-attention tile: 16 queries of the 64-row "
          f"wgmma tile {c16:.4f} ms, 64 queries {c64:.4f} ms on the device "
          f"with cold L2 (ratio {c16 / c64:.3f}) [{card}]")
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
        "runtime_launches": launcher["lm"]["launches"],
        "family_launches": family_launches,
        "max_abs_err": served_err[torch.bfloat16], "ms": served_t["ms"],
        "device_ms": served_t["device_ms"], "plain_ms": served_t["plain_ms"],
        "bound_ms": served_t["bound_ms"], "bound_by": served_t["bound_by"],
        "library_ms": served_t["lib_ms"],
        "library_device_ms": served_t["lib_device_ms"],
        "shapes": {name: {
            key: flash_ms[name][k] for key, k in (
                ("ms", "ms"), ("device_ms", "device_ms"),
                ("plain_ms", "plain_ms"), ("bound_ms", "bound_ms"),
                ("bound_by", "bound_by"), ("library_ms", "lib_ms"),
                ("library_device_ms", "lib_device_ms"),
                ("l2_warm_device_ms", "warm_device_ms"),
                ("library_l2_warm_device_ms", "lib_warm_device_ms"))
            if k in flash_ms[name]}
            for name in flash_shapes if name != "served"}})
    records[-1]["shapes"]["seq_rank"].update(
        max_abs_err=seq_err[torch.bfloat16, seq[6]], shape=list(seq[:6]),
        q_offset=seq[6])

    # 13. the encdec family at its published size and the int8 KV cache
    t0 = time.perf_counter()
    shape_err = {}
    for name in ("encoder", "decoder", "cross"):
        B_, Sq, Sk, H_, K_, hd_, causal, _, _ = flash_shapes[name]
        shape_err[name] = {dt: compare_flash(B_, Sq, Sk, H_, K_, hd_, causal,
                                             dt, device,
                                             steps=FLASH_BF16_STEPS)
                           for dt in (torch.float32, torch.bfloat16)}
        records[-1]["shapes"][name]["max_abs_err"] = \
            shape_err[name][torch.bfloat16]
    print("flash_forward vs its plain version at the encdec shapes: "
          + "; ".join(f"{n} f32 {e[torch.float32]:.3g}, bf16 "
                      f"{e[torch.bfloat16]:.3g}" for n, e in shape_err.items())
          + f" (tol f32 {FLASH_TOL_F32}, bf16 {FLASH_BF16_STEPS} bf16 steps "
          f"of the largest |out|, absolute); two launches bit-identical")
    eprompts = lm_prompts(ecfg, ENCDEC_BATCH, ENCDEC_PROMPT)
    enc = torch.randn(ENCDEC_BATCH, frames, ecfg.d_model, device=device,
                      generator=torch.Generator(device=device)
                      .manual_seed(LM_SEED))
    ed = encdec_path(ecfg, eprompts, enc, ENCDEC_NEW, device)
    te, tc = ed["times"], ed["times_cold"]
    print(f"encdec main path ({time.perf_counter() - t0:.1f} s host wall "
          f"incl. init, 5 runs and teacher forcing): {ecfg.name} "
          f"{ecfg.enc_layers}+{ecfg.n_layers} layers d={ecfg.d_model} heads "
          f"{ecfg.n_heads}/{ecfg.n_kv} hd={ecfg.head_dim} d_ff={ecfg.d_ff} "
          f"({ecfg.mlp}) vocab {ecfg.vocab}, {ed['n_params']} params "
          f"(seeded, bf16 on backend=cuda; param_count() "
          f"{ecfg.param_count()}); {ENCDEC_BATCH} x {frames} frames, "
          f"prompts {ENCDEC_BATCH}x{ENCDEC_PROMPT}, {ENCDEC_NEW} greedy "
          f"tokens: flash_forward launches {ed['launches']} "
          f"({sum(ed['launches'].values())} in all; by route "
          f"{ed['routes']}), no other kernel")
    print(f"encdec checks: f32 greedy tokens cuda == torch; prefill logits "
          f"cuda vs torch max|diff| / max|logit|: f32 {ed['err32']:.3g} "
          f"(tol {LM_LOGIT_TOL_F32}), bf16 {ed['err16']:.3g} (tol "
          f"{LM_LOGIT_TOL_BF16}); bf16 cuda vs f32 torch "
          f"{ed['err16_vs32']:.3g}; teacher-forced decode vs forward "
          f"({ed['steps']} steps, f32) max|diff| {ed['dec_err']:.3g} (tol "
          f"{LM_DECODE_TOL})")
    print(f"encdec served (bf16, host clock around synchronised calls, "
          f"second run): init_decode_state (encode + cross K/V) "
          f"{te['init_ms']:.2f} ms, prefill {te['prefill_ms']:.2f} ms, "
          f"decode {te['decode_ms'] / ENCDEC_NEW:.3f} ms per token; first "
          f"run {tc['init_ms']:.2f} / {tc['prefill_ms']:.2f} / "
          f"{tc['decode_ms'] / ENCDEC_NEW:.3f} [{card}]")
    encdec_launches = sum(ed["launches"].values())
    del ed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    kq = kv_quant_path(cfg, prompts, LM_NEW, device)
    tq, tb = kq["times"]["int8"], kq["times"]["bf16"]
    print(f"int8 KV cache ({time.perf_counter() - t0:.1f} s host wall): "
          f"{cfg.name} LMServer(batch={LM_BATCH}, max_len="
          f"{LM_PROMPT + LM_NEW + 1}, kv_quant=True).generate({LM_BATCH}x"
          f"{LM_PROMPT}, n_new={LM_NEW}) bf16 on backend=cuda: "
          f"flash_forward launches {kq['launches']} (routes {kq['routes']}) "
          f"for {kq['n_attn']} attention layers, no other kernel; f32 "
          f"greedy tokens cuda == torch; state bytes {kq['ratio']:.4f} of "
          f"the bf16 state's (at most {KV_QUANT_BYTES}); new tokens equal "
          f"to the bf16 cache's {kq['agree']:.1%}")
    print(f"int8 KV cache served (bf16, host clock around synchronised "
          f"calls, second call, in turns with the bf16 cache): prefill "
          f"{tq['prefill_ms']:.2f} ms, decode {tq['decode_ms'] / LM_NEW:.3f}"
          f" ms per token; bf16 cache prefill {tb['prefill_ms']:.2f} ms, "
          f"decode {tb['decode_ms'] / LM_NEW:.3f} ms per token [{card}]")
    records[-1].update(encdec_launches=encdec_launches,
                       kv_quant_launches=kq["launches"])

    # 14. training: no kernel in the step
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launches()
    train_ref = {}
    train = train_path(device, card, train_ref)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"training launched kernels: {counts}")
    for rec in records:
        rec["train_launches"] = 0
    print(f"training phase: {time.perf_counter() - t0:.1f} s host wall; "
          f"kernel launches in it {counts} (none: backend=\"torch\") "
          f"[{card}]")
    print(json.dumps({"training": train}))

    # 15. data-parallel training over a one-rank NCCL group
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launches()
    dp = dp_path(device, card, train_ref)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"data-parallel training launched kernels: "
                             f"{counts}")
    del train_ref
    for rec in records:
        rec["dp_launches"] = 0
    print(f"data-parallel phase: {time.perf_counter() - t0:.1f} s host "
          f"wall; kernel launches in it {counts} [{card}]")
    print(json.dumps({"data_parallel": dp}))

    # 16. tensor-parallel training, four ranks on the one card over gloo
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_launches()
    tp = tp_path(device, card)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"tensor-parallel training launched kernels: "
                             f"{counts}")
    for rec in records:
        rec["tp_launches"] = 0
    print(f"tensor-parallel phase: {time.perf_counter() - t0:.1f} s host "
          f"wall (mesh-less references {tp['reference_s']:.1f} s, ranks "
          f"{tp['ranks_s']:.1f} s); kernel launches in it {counts} and in "
          f"every rank none [{card}]")
    print(json.dumps({"tensor_parallel": tp}))

    # 17. the dry run of every production training cell, on the host
    t0 = time.perf_counter()
    reset_launches()
    dr = dryrun_path(card, train)
    counts = launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the dry run launched kernels: {counts}")
    print(f"dry-run phase: {time.perf_counter() - t0:.1f} s host wall "
          f"({dr['workers']} processes); kernel launches in it {counts} "
          f"[{card}]")
    print(json.dumps({"dry_run": dr}))

    # 18. sharded serving, four ranks on the one card over gloo; then the
    # flash kernel at the per-rank prefill shape of (a)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    st = serve_tp_path(device, card)
    for rec in records:
        rec["serve_tp_launches"] = st["launches"] if \
            rec["name"] == "flash_forward" else 0
    print(f"sharded-serving phase: {time.perf_counter() - t0:.1f} s host "
          f"wall (mesh-less references {st['reference_s']:.1f} s, ranks "
          f"{st['ranks_s']:.1f} s); flash_forward launches in the ranks' "
          f"prefills {st['launches']} [{card}]")
    reset_launches()
    st["flash_rank_shape"] = serve_flash_shape(device, card)
    flash_rec = next(r for r in records if r["name"] == "flash_forward")
    ft = st["flash_rank_shape"]
    flash_rec["shapes"]["serve_tp_rank"] = {
        "ms": ft["ms"], "device_ms": ft["device_ms"],
        "plain_ms": ft["plain_ms"], "bound_ms": ft["bound_ms"],
        "bound_by": ft["bound_by"], "library_ms": ft["lib_ms"],
        "library_device_ms": ft["lib_device_ms"],
        "max_abs_err": ft["max_abs_err"], "shape": ft["shape"]}
    print(json.dumps({"sharded_serving": st}))

    # 19. the reference's five examples as the port's entry points
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ex = examples_path(device, card)
    keys = {"qs_forward": "bitvector", "qs_bitmm_forward": "bitmm",
            "gemm_forward": "gemm", "cascade_qs_forward": "cascade",
            "flash_forward": "flash"}
    for rec in records:
        if rec["name"] == "quantize_rows":
            rec["examples_launches"] = {
                label: run["transform_launches"]
                for label, run in ex.items()}
            continue
        key = keys[rec["name"]]
        rec["examples_launches"] = {label: run["launches"][key]
                                    for label, run in ex.items()}
        rec["examples_launches_by_route"] = {label: run["routes"][key]
                                             for label, run in ex.items()}
    print(f"examples phase: {time.perf_counter() - t0:.1f} s host wall ("
          + ", ".join(f"{label} {run['s']:.1f} s" for label, run in
                      ex.items())
          + f") [{card}]")
    print(json.dumps({"examples": ex}, default=float))

    print(f"chip_smoke.py took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
