"""Staged (cascade) ensemble evaluation over any registered engine — the
port's counterpart of ``repro.cascade.predictor``.

The forest is partitioned into K tree-prefix stages; each stage's delta
sub-forest (trees ``[stages[k-1], stages[k])``) is compiled through the
ordinary engine registry, and between stages a ``GatePolicy`` decides
which rows exit early.  Surviving rows are gathered into a shrinking
batch, padded to the next power of two (``engine_select.bucket_batch``),
so every stage sees at most O(log B) distinct batch shapes.

Exactness: a row that reaches the last stage has accumulated every tree's
contribution, so with the gate disabled (``MarginGate(inf)`` or a single
stage) the cascade computes the same function as the underlying engine —
bit-exact on quantized forests (integer partial sums, power-of-two leaf
scale).

``CascadePredictor`` satisfies the ``core.registry.Predictor`` protocol
and serves through ``ForestServer`` (per-stage exit counts land in
``ServerStats``).  ``repro_torch.io.save_predictor`` writes it as a packed
cascade artifact.  ``trace_cache_size`` waits for ``repro_torch.obs``
(ROADMAP Queue A item 9).
"""
from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..core import registry
from ..core.engine_select import bucket_batch
from ..core.forest import Forest
from ..core.quantize import quantize_inputs
from ..core.registry import normalize_scores, resolve_device
from .policy import GatePolicy, MarginGate


def default_policy() -> GatePolicy:
    return MarginGate(0.9)


@dataclass(frozen=True)
class CascadeSpec:
    """Declarative cascade request: stage boundaries (cumulative tree
    counts — ``(16, 48, 192)`` evaluates 16 trees, then 32 more, then 144
    more) plus the gate policy.  ``policy=None`` → ``MarginGate(0.9)``.
    ``fused=True`` lowers to ``FusedCascadePredictor``.  Passed to
    ``core.compile_forest(..., cascade=...)`` / ``compile_plan``."""
    stages: tuple
    policy: Optional[GatePolicy] = None
    fused: bool = False

    def resolved_policy(self) -> GatePolicy:
        return self.policy if self.policy is not None else default_policy()

    def tag(self) -> str:
        """Candidate tag, e.g. ``cascade=16/48:margin0.9`` or
        ``cascade-fused=16/48:margin0.9``: every field that changes the
        compiled variant participates."""
        s = "/".join(str(int(x)) for x in self.stages)
        kind = "cascade-fused" if self.fused else "cascade"
        return f"{kind}={s}:{self.resolved_policy().tag()}"


def normalize_stages(stages: Sequence[int], n_trees: int) -> tuple:
    """Sorted unique positive boundaries, clamped to ``n_trees``; the
    final stage always covers the whole forest (appended if missing)."""
    out = sorted({min(int(s), n_trees) for s in stages})
    if any(s <= 0 for s in out):
        raise ValueError(f"stage boundaries must be positive, got {stages}")
    if not out or out[-1] != n_trees:
        out.append(n_trees)
    return tuple(out)


def tree_slice(forest: Forest, start: int, stop: int) -> Forest:
    """Sub-forest of trees ``[start, stop)`` — shares the ensemble-wide
    padding (L) and all quantization metadata, so per-stage engine
    outputs descale identically to the full forest's."""
    sl = slice(start, stop)
    return dataclasses.replace(
        forest, n_trees=stop - start,
        feature=forest.feature[sl], threshold=forest.threshold[sl],
        left=forest.left[sl], right=forest.right[sl],
        leaf_lo=forest.leaf_lo[sl], leaf_mid=forest.leaf_mid[sl],
        leaf_hi=forest.leaf_hi[sl], leaf_value=forest.leaf_value[sl],
        n_nodes=forest.n_nodes[sl],
        n_leaves_per_tree=forest.n_leaves_per_tree[sl])


class CascadePredictor:
    """Confidence-gated staged evaluation wrapping any registered engine.

    ``stage_predictors`` injects pre-built per-stage predictors; otherwise
    each stage's delta sub-forest is built through ``core.registry`` with
    the given engine/backend/engine_kw on ``device`` (``None`` → the
    card, ``"cpu"`` → the CPU).  The gate runs on the same device.
    """

    def __init__(self, forest: Forest, spec: CascadeSpec, *,
                 engine: str = "bitvector", backend: str = "torch",
                 engine_kw: Optional[dict] = None,
                 stage_predictors: Optional[list] = None, device=None):
        self.forest = forest
        self.engine = engine
        self.backend = backend
        self.engine_kw = dict(engine_kw or {})
        self.device = resolve_device(device)
        self.stages = normalize_stages(spec.stages, forest.n_trees)
        bounds = (0,) + self.stages
        if stage_predictors is not None:
            if len(stage_predictors) != len(self.stages):
                raise ValueError(
                    f"{len(stage_predictors)} stage predictors for "
                    f"{len(self.stages)} stages {self.stages}")
            self.stage_predictors = list(stage_predictors)
        else:
            build = registry.get(engine, backend).build_fn()
            self.stage_predictors = [
                build(tree_slice(forest, bounds[k], bounds[k + 1]),
                      device=self.device, **self.engine_kw)
                for k in range(len(self.stages))]
        # quantize once, not once per surviving stage: every stage slice
        # shares the full forest's quantization metadata
        self._pre_transform = all(
            hasattr(p, "predict_transformed") for p in self.stage_predictors)
        self.set_policy(spec.resolved_policy())
        self.reset_exit_stats()

    # ------------------------------------------------------------- policy
    def set_policy(self, policy: GatePolicy) -> None:
        """Install (a copy of) ``policy``, prepared for this cascade's
        forest and stages and gating on its device."""
        self.policy = copy.copy(policy)
        self.policy.device = self.device
        self.policy.prepare(self.forest, self.stages)

    #: class-level flag — ``FusedCascadePredictor`` flips it
    fused = False

    @property
    def spec(self) -> CascadeSpec:
        return CascadeSpec(stages=self.stages, policy=self.policy,
                           fused=self.fused)

    def describe(self) -> str:
        s = "/".join(str(x) for x in self.stages)
        d = f"stages={s} policy={self.policy.tag()}"
        return f"fused {d}" if self.fused else d

    @property
    def host_syncs(self) -> int:
        """Device→host synchronizations per ``predict`` batch: the staged
        loop brings every stage's scores to the host for the gate."""
        return len(self.stages)

    def trace_cache_size(self) -> Optional[int]:
        raise NotImplementedError(
            "trace_cache_size needs repro_torch.obs, ported in the "
            "serving-runtime slice (ROADMAP Queue A item 9)")

    # ------------------------------------------------------------ serving
    def reset_exit_stats(self) -> None:
        K = len(self.stages)
        self.last_exit_counts = np.zeros(K, dtype=np.int64)
        self.exit_counts = np.zeros(K, dtype=np.int64)

    @property
    def exit_fractions(self) -> np.ndarray:
        """Cumulative per-stage exit fractions over every ``predict``
        since the last ``reset_exit_stats``."""
        tot = int(self.exit_counts.sum())
        return self.exit_counts / max(tot, 1)

    @property
    def mean_trees_evaluated(self) -> float:
        """Mean trees evaluated per row under the cumulative exit counts
        (full forest = ``n_trees``)."""
        tot = int(self.exit_counts.sum())
        if tot == 0:
            return float(self.forest.n_trees)
        return float((self.exit_counts * np.asarray(self.stages)).sum() / tot)

    # --------------------------------------------------------- prediction
    def transform_inputs(self, X: np.ndarray) -> np.ndarray:
        return quantize_inputs(self.forest, np.asarray(X))

    def host_forest(self) -> Forest:
        return self.forest

    def _stage_scores(self, k: int, X: np.ndarray) -> np.ndarray:
        """One stage's delta scores for the active rows, padded with zero
        rows to the power-of-two bucket.  ``X`` is pre-transformed when
        ``_pre_transform`` is set, raw otherwise."""
        n = X.shape[0]
        bucket = bucket_batch(n)
        if bucket > n:
            X = np.concatenate(
                [X, np.zeros((bucket - n,) + X.shape[1:], dtype=X.dtype)])
        pred = self.stage_predictors[k]
        out = pred.predict_transformed(X) if self._pre_transform \
            else pred.predict(X)
        return out[:n]

    def predict(self, X: np.ndarray) -> np.ndarray:
        """(B, d) → (B, C) scores.  Rows that exit early return their
        cumulative prefix scores; rows that reach the last stage carry
        the exact full-forest score."""
        X = np.asarray(X)
        feed = self.transform_inputs(X) if self._pre_transform else X
        B = X.shape[0]
        K = len(self.stages)
        out = np.zeros((B, self.forest.n_classes), dtype=np.float32)
        counts = np.zeros(K, dtype=np.int64)
        active = np.arange(B)
        for k in range(K):
            if active.size == 0:
                break
            out[active] += self._stage_scores(k, feed[active])
            if k == K - 1:
                counts[k] += active.size
                break
            ex = self.policy.exits(out[active], k)
            counts[k] += int(ex.sum())
            active = active[~ex]
        self.last_exit_counts = counts
        self.exit_counts += counts
        return out

    def predict_class(self, X: np.ndarray) -> np.ndarray:
        return self.predict(X).argmax(axis=1)

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        # same votes-vs-logits rule as the gate's confidence normalization
        return normalize_scores(self.predict(X),
                                votes=registry.votes_mode(self.forest))

    def cumulative_scores(self, X: np.ndarray) -> np.ndarray:
        """(K, B, C) cumulative scores after each stage with the gate held
        open — the calibration input; ``cumulative_scores(X)[-1]`` equals
        the underlying engine's full-forest prediction."""
        X = np.asarray(X)
        feed = self.transform_inputs(X) if self._pre_transform else X
        acc = np.zeros((X.shape[0], self.forest.n_classes), dtype=np.float32)
        out = []
        for k in range(len(self.stages)):
            acc = acc + self._stage_scores(k, feed)
            out.append(acc)
        return np.stack(out)
