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
     A zero count ends the batch.
  4. **Scatter + gate** — the bucket's delta scores are added back through
     the permutation (lanes past the survivor count masked to zero), and
     the policy's ``decide`` — the same rule the staged loop's ``exits``
     runs — marks exits.

**Tier 2, kernel** (``engine="bitvector"`` on ``backend="cuda"``): one
``cascade_qs_forward`` launch per batch runs every stage, the gate and the
survivor mask; the per-stage exit counts are reduced on the device, and
reading them is the batch's one wait for the device (``host_syncs == 1``).

Rows that exit keep their frozen cumulative score — the staged loop's
semantics, and bit-exact against it on quantized forests: per-row
traversal does not depend on the batch, integer partial sums make every
reduction order agree, and the gate sees the same f32 values.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.engine_select import bucket_batch
from ..core.forest import Forest
from ..core.registry import as_input_tensor, ensure_feature_column
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

    # ------------------------------------------------------------- policy
    def set_policy(self, policy) -> None:
        super().set_policy(policy)
        # the programs close over the policy: a stale one must go
        self._program = None
        if self._use_kernel:
            # reject a policy without a device form now, not at predict
            self.policy.kernel_gate(len(self.stages))

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
        """Tier 1: ``(Xp, n) -> (scores on the device, counts on the
        host)`` over a (Bp, d) zero-padded batch on the device, the first
        ``n`` rows real."""
        stage_fns = self._stage_fns
        decide = self.policy.decide
        K = len(self.stages)
        C = self.forest.n_classes

        def run(Xp, n):
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
                    counts[k] += n_act
                else:
                    ex = decide(acc, k) & active
                    nex = int(ex.sum())      # the stage's one host read
                    counts[k] += nex
                    active &= ~ex
                    n_act -= nex
            return acc, counts

        return run

    def _kernel_program(self):
        """Tier 2: the single CUDA cascade kernel plus on-device exit
        accounting (per-row exit stage → one-hot → per-stage counts)."""
        from ..kernels import ops as kops
        fn = kops.cuda_fused_cascade_qs(
            self.forest, self.stages, self.policy, device=self.device,
            **self.engine_kw)
        K = len(self.stages)

        def run(Xp, n):
            valid = torch.arange(Xp.shape[0], device=Xp.device) < n
            scores, exit_stage = fn(Xp, valid)
            stages = torch.arange(K, dtype=torch.int32, device=Xp.device)
            hot = (exit_stage[:, None] == stages[None, :]) & valid[:, None]
            # the tier's one wait for the device
            return scores, hot.sum(dim=0).cpu().numpy().astype(np.int64)

        return run

    def _fused_call(self):
        if self._program is None:
            self._program = self._kernel_program() if self._use_kernel \
                else self._fused_program()
        return self._program

    # --------------------------------------------------------- prediction
    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        K = len(self.stages)
        if X.shape[0] == 0:
            self.last_exit_counts = np.zeros(K, dtype=np.int64)
            return np.zeros((0, self.forest.n_classes), dtype=np.float32)
        feed = ensure_feature_column(np.asarray(self.transform_inputs(X)))
        if self._feed_f32:
            feed = feed.astype(np.float32)
        n, mult = feed.shape[0], self._row_mult
        # the staged loop's power-of-two bucketing, in units of blocks
        bucket = mult * bucket_batch(-(-n // mult)) if mult > 1 \
            else bucket_batch(n)
        Xp = np.zeros((bucket,) + feed.shape[1:], dtype=feed.dtype)
        Xp[:n] = feed
        scores, counts = self._fused_call()(
            as_input_tensor(Xp, self.device), n)
        out = scores[:n].cpu().numpy()
        self.last_exit_counts = counts
        self.exit_counts += counts
        return out

    @property
    def host_syncs(self) -> int:
        """Device→host reads per ``predict`` batch: one for the kernel
        tier; for the generic tier one per gate plus the result read."""
        return 1 if self._use_kernel else len(self.stages)
