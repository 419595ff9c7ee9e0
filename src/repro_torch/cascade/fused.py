"""Fused cascade execution — the port's counterpart of
``repro.cascade.fused``.

The staged ``CascadePredictor.predict`` brings every stage's scores back
to the host for the gate, gathers survivors on the host, and pads each
stage's batch anew.  ``FusedCascadePredictor`` keeps the scores, the gate
and the survivor mask on the device, in one of two tiers.

**Tier 1, generic** (every engine and backend).  Per stage:

  1. **Stage 0** — every valid row is active, and valid rows are a
     prefix of the padded batch: the identity permutation compacts.
  2. **Compact** — before each later stage a prefix sum over the survivor
     mask ranks active rows first (in original order), exited rows after,
     and a scatter turns the ranks into a permutation; no sort.
  3. **Bucket** — the smallest size of the bucket ladder (``_bucket_ladder``,
     the reference's) that covers the survivor count is evaluated.  The
     reference picks it in-graph with ``lax.switch``; here the host picks
     it from the survivor count, which it reads once per gate (``K - 1``
     small reads, plus the one read of the results: ``host_syncs == K``).
     A zero count ends the batch (and the reads with it).
  4. **Scatter + gate** — the bucket's delta scores are added back through
     the permutation (lanes past the survivor count masked to zero), and
     the policy's ``decide`` — the same rule the staged loop's ``exits``
     runs — marks exits.

**Tier 2, kernel** (``engine="bitvector"`` on ``backend="cuda"``): one
``cascade_qs_forward`` launch per batch runs every stage, the gate and the
survivor mask; the per-stage exit counts are reduced on the device and
travel back with the scores in one int32 buffer (the scores' f32 bits,
then the counts), whose read is the batch's one wait for the device
(``host_syncs == 1``).

On the card, with kernel stages and a forest with integer thresholds,
the rows are quantized there too: ``transform_inputs`` copies the raw rows
once and ``quantize_rows`` writes the zero-padded bucket both tiers run
(``kernels.ops.InputGrid``); elsewhere the host quantizes and pads them.

Each blocking read is a ``repro_torch.d2h`` span (``repro_torch.obs.trace``),
beside ``launch`` spans for the device work each tier enqueues.

Rows that exit keep their frozen cumulative score — the staged loop's
semantics, and bit-exact against it on quantized forests: per-row
traversal does not depend on the batch, integer partial sums make every
reduction order agree, and the gate sees the same f32 values.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..core.engine_select import bucket_batch
from ..core.forest import Forest
from ..core.registry import as_input_tensor, ensure_feature_column
from ..kernels import ops as kops
from ..obs import trace
from .predictor import CascadePredictor, CascadeSpec


def _stage_eval_fn(pred):
    """One stage predictor → ``X (n, d) tensor on its device -> (n, C)
    descaled f32 tensor``, computed as its ``predict_transformed`` does:
    registry engines through ``_eval``, kernel predictors through their
    kernel ``launch`` and the same descale."""
    launch = getattr(pred, "launch", None)
    if launch is not None:
        arrays, out_dtype = pred.arrays, pred.out_dtype
        scale = pred.leaf_scale
        return lambda X: launch(X, *arrays, out_dtype=out_dtype).to(
            torch.float32) / scale
    fn, compiled = getattr(pred, "_eval", None), getattr(pred, "compiled",
                                                         None)
    if fn is None or compiled is None:
        raise TypeError(
            f"stage predictor {type(pred).__name__} exposes no device "
            "evaluator (_eval or launch) — fused cascade execution needs "
            "one; use the staged CascadePredictor for this engine")
    return lambda X: fn(compiled, X)


class FusedCascadePredictor(CascadePredictor):
    """Drop-in ``CascadePredictor`` whose ``predict`` keeps scores, gate
    and survivors on the device (module docstring).  Stage building,
    policy handling, calibration, exit-stat accounting are inherited —
    only the hot path and its sync count change."""

    fused = True

    def __init__(self, forest: Forest, spec: CascadeSpec, *,
                 engine: str = "bitvector", backend: str = "torch",
                 engine_kw: Optional[dict] = None,
                 stage_predictors: Optional[list] = None, device=None):
        # the bitvector/cuda pair gets the single-kernel tier
        self._use_kernel = (engine == "bitvector" and backend == "cuda"
                            and stage_predictors is None)
        super().__init__(forest, spec, engine=engine, backend=backend,
                         engine_kw=engine_kw,
                         stage_predictors=stage_predictors, device=device)
        self._stage_fns = [_stage_eval_fn(p) for p in self.stage_predictors]
        blocks = [p.block_b for p in self.stage_predictors
                  if hasattr(p, "block_b")]
        # kernel stages take f32 rows; their batch block floors the
        # bucket ladder, as the reference's Pallas stages do
        self._row_mult = max(blocks) if blocks else 1
        self._feed_f32 = bool(blocks)

    @functools.cached_property
    def _grid(self):
        """The card's input grid, made on the first transform."""
        return kops.input_grid(self.forest, self.device) \
            if self._feed_f32 else None

    # ------------------------------------------------------------- policy
    def set_policy(self, policy) -> None:
        super().set_policy(policy)
        # the programs close over the policy: a stale one must go, and
        # with it the buckets it ran
        self._program = None
        self._buckets: set = set()
        if self._use_kernel:
            # reject a policy without a device form now, not at predict
            self.policy.kernel_gate(len(self.stages))

    def trace_cache_size(self) -> Optional[int]:
        """The stages' first-use entries plus the distinct buckets the
        fused program ran — ``obs.retrace.CompileWatch`` treats the drop
        after ``set_policy`` as a deliberate reset, not negative
        compiles."""
        return (super().trace_cache_size() or 0) + len(self._buckets)

    # ---------------------------------------------------------- programs
    def _bucket_ladder(self, Bp: int) -> list:
        """Bucket sizes: ``F·2^j`` and ``3F·2^j`` up to Bp, F the floor
        (16 rows, or the kernel's batch block), densified with 5/8 and 7/8
        steps near the top, where over-evaluation costs most."""
        floor = min(max(16, self._row_mult), Bp)
        half = self._row_mult if self._row_mult > 1 \
            else max(floor // 2, 1)
        sizes = set([Bp])
        s = floor
        while s < Bp:
            sizes.add(s)
            s *= 2
        for m, lo in ((3, Bp // 4), (5, Bp // 2), (7, Bp // 2)):
            s = m * half
            while s < Bp:
                if s >= max(floor, lo):
                    sizes.add(s)
                s *= 2
        return sorted(sizes)

    def _fused_program(self):
        """Tier 1: ``(Xp, n) -> (scores (n, C), counts (K,))`` on the host
        for a (Bp, d) zero-padded batch on the device, the first ``n`` rows
        real."""
        stage_fns = self._stage_fns
        decide = self.policy.decide
        K = len(self.stages)
        C = self.forest.n_classes

        def run(Xp, n):
            t = trace.begin("repro_torch.launch")
            Bp = Xp.shape[0]
            dev = Xp.device
            iota = torch.arange(Bp, device=dev)
            acc = torch.zeros((Bp, C), dtype=torch.float32, device=dev)
            counts = np.zeros(K, dtype=np.int64)
            active = iota < n
            n_act = n
            sizes = self._bucket_ladder(Bp)
            for k in range(K):
                if n_act == 0:
                    break            # every row has exited
                if k == 0:
                    order = iota
                else:
                    t = trace.begin("repro_torch.launch")
                    # survivors to the front by prefix-sum ranks, scattered
                    # into a permutation; original row order preserved
                    na = active.to(torch.int64)
                    pos = torch.where(active, torch.cumsum(na, 0) - 1,
                                      n_act + torch.cumsum(1 - na, 0) - 1)
                    order = torch.zeros_like(iota).scatter_(0, pos, iota)
                size = next(s for s in sizes if s >= n_act)
                idx = order[:size]
                delta = stage_fns[k](Xp[idx])
                ok = torch.arange(size, device=dev) < n_act
                acc.index_add_(0, idx, torch.where(ok[:, None], delta, 0.0))
                if k == K - 1:
                    trace.end(t)
                    counts[k] += n_act
                else:
                    ex = decide(acc, k) & active
                    n_ex = ex.sum()
                    trace.end(t)
                    t = trace.begin("repro_torch.d2h")
                    nex = int(n_ex)          # the stage's one host read
                    trace.end(t, nbytes=n_ex.element_size())
                    counts[k] += nex
                    active &= ~ex
                    n_act -= nex
            t = trace.begin("repro_torch.d2h")
            out = acc[:n].cpu().numpy()
            trace.end(t, nbytes=out.nbytes)
            return out, counts

        return run

    def _kernel_program(self):
        """Tier 2: the single CUDA cascade kernel plus on-device exit
        accounting (per-row exit stage → one-hot → per-stage counts), read
        back with the scores in one copy."""
        fn = kops.cuda_fused_cascade_qs(
            self.forest, self.stages, self.policy, device=self.device,
            **self.engine_kw)
        K = len(self.stages)

        def run(Xp, n):
            t = trace.begin("repro_torch.launch")
            valid = torch.arange(Xp.shape[0], device=Xp.device) < n
            scores, exit_stage = fn(Xp, valid)
            stages = torch.arange(K, dtype=torch.int32, device=Xp.device)
            hot = (exit_stage[:, None] == stages[None, :]) & valid[:, None]
            # the scores' f32 bits and the int32 counts in one buffer
            packed = torch.cat([scores[:n].reshape(-1).view(torch.int32),
                                hot.sum(dim=0, dtype=torch.int32)])
            trace.end(t)
            t = trace.begin("repro_torch.d2h")
            host = packed.cpu().numpy()          # the tier's one host read
            trace.end(t, nbytes=host.nbytes)
            m = host.size - K
            return (host[:m].view(np.float32).reshape(n, -1),
                    host[m:].astype(np.int64))

        return run

    def _fused_call(self):
        if self._program is None:
            self._program = self._kernel_program() if self._use_kernel \
                else self._fused_program()
        return self._program

    # --------------------------------------------------------- prediction
    def _bucket(self, n: int) -> int:
        """The staged loop's power-of-two bucketing, in units of blocks."""
        mult = self._row_mult
        return mult * bucket_batch(-(-n // mult)) if mult > 1 \
            else bucket_batch(n)

    def transform_inputs(self, X: np.ndarray):
        """On the card with a grid, a ``kernels.ops.CardFeed``: the rows
        quantized on the card into the bucket ``predict`` runs.  Else the
        host's transform (``CascadePredictor.transform_inputs``)."""
        if self._grid is None:
            return super().transform_inputs(X)
        X = np.asarray(X)
        return self._grid.feed(X, self._bucket(len(X)))

    def _host_feed(self, feed: np.ndarray):
        """Host-transformed rows → (the zero-padded bucket on the device,
        the row count)."""
        t = trace.begin("repro_torch.pad")
        feed = ensure_feature_column(np.asarray(feed))
        if self._feed_f32:
            feed = feed.astype(np.float32)
        n = feed.shape[0]
        bucket = self._bucket(n)
        Xp = np.zeros((bucket,) + feed.shape[1:], dtype=feed.dtype)
        Xp[:n] = feed
        trace.end(t, rows=n, padded_rows=bucket)
        t = trace.begin("repro_torch.h2d")
        xt = as_input_tensor(Xp, self.device)
        trace.end(t, nbytes=Xp.nbytes)
        return xt, n

    def predict(self, X: np.ndarray) -> np.ndarray:
        root = trace.begin("repro_torch.predict")
        try:
            X = np.asarray(X)
            K = len(self.stages)
            if X.shape[0] == 0:
                self.last_exit_counts = np.zeros(K, dtype=np.int64)
                return np.zeros((0, self.forest.n_classes), dtype=np.float32)
            program = self._fused_call()  # the kernel tier builds on first use
            t = trace.begin("repro_torch.transform")
            feed = self.transform_inputs(X)
            trace.end(t)
            xt, n = feed if isinstance(feed, kops.CardFeed) \
                else self._host_feed(feed)
            out, counts = program(xt, n)
            self._buckets.add(tuple(xt.shape))
            self.last_exit_counts = counts
            self.exit_counts += counts
            return out
        finally:
            trace.end(root, rows=len(X))

    @property
    def host_syncs(self) -> int:
        """Device→host reads per ``predict`` batch: one for the kernel
        tier; for the generic tier one per gate plus the result read."""
        return 1 if self._use_kernel else len(self.stages)
