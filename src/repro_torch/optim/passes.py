"""Forest optimizer middle-end: registered, recorded, verifiable IR→IR
passes running between ``quantize`` and ``layout`` in the compile
pipeline (``core/pipeline.py``).  The port's copy of
``repro.optim.passes`` (numpy only): the same passes give array-equal IR
and the same per-pass stats in both packages.

The paper's Table 4 observation — equivalent-node merging and threshold
collapse (especially after quantization) shrink the work every traversal
does — lives here as compiler passes visible to *every* engine, instead
of inside RapidScorer's compile step.  Five passes ship:

  * ``dedup_thresholds``       — per-feature threshold canonicalization:
    ``-0.0`` → ``+0.0`` (bit-identical thresholds merge in RapidScorer's
    unique table) and dominated-split elimination — a node whose
    per-feature reachable interval already decides its predicate is
    replaced by the taken subtree.  Quantization collapses distinct float
    thresholds onto one grid point, so collapsed forests are where this
    pass bites hardest (the paper's "threshold collapse").
  * ``merge_equivalent_leaves`` — generalizes RapidScorer's equivalent-
    node merging to the IR: a split whose two children are leaves with
    bit-identical values becomes that leaf (applied bottom-up, so whole
    constant subtrees fold).
  * ``compact``                — strip dead padding: rebuild every tree
    (dropping nodes unreachable from the root), shrink the ensemble
    padding width ``L`` to the real per-tree maximum, drop all-zero
    constant trees (they add exactly 0 to every score), and recompute
    ``max_depth``.  Smaller ``L`` directly shrinks every engine's node
    and leaf tables (QuickScorer masks are (T, L-1, W)).
  * ``drop_unused_features``   — remap the feature axis to the columns
    the forest actually reads, recording the remap in
    ``Forest.feat_map`` so ``transform_inputs`` still accepts full-width
    rows (callers never change).
  * ``reorder_trees``          — discriminative-first tree ordering
    (Daghero et al.: ordering determines early-exit efficiency): trees
    whose scores vary most across a validation set (``X_calib``; leaf-
    value spread as the data-free fallback) come first, so cascade
    prefixes decide more rows earlier (``repro_torch.cascade``).

Equivalence contract (docs/OPTIM.md): every pass preserves
``predict_oracle`` over all finite inputs — bit-exactly when the leaf
table is integer (quantized forests: sums reassociate losslessly), and
up to float summation reassociation otherwise (only ``reorder_trees``
even moves the sum order).  ``optimize`` *always* runs the oracle-
equivalence check after the pass list; a pass that breaks it raises
``OptimizationError`` at compile time instead of serving wrong scores.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Optional, Sequence, Union

import numpy as np

from ..core.forest import Forest
from ..core.quantize import quantize_inputs
from .analysis import n_unique_splits
from .rewrite import Node, count_leaves, extract_tree, leaf, rebuild_forest


class OptimizationError(RuntimeError):
    """An optimizer pass failed its oracle-equivalence check."""


# --------------------------------------------------------------------------- #
# Pass registry (mirrors core/registry.py's engine registry)
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class OptPass:
    name: str
    fn: Callable                  # (forest, ctx) -> Forest
    doc: str = ""


OPT_PASSES: dict[str, OptPass] = {}


def register_pass(name: str, *, doc: str = ""):
    """Decorator: register an IR→IR optimizer pass under ``name``.

    The callable takes ``(forest, ctx)`` and returns a Forest computing
    the same function (the equivalence contract above); ``ctx`` may carry
    ``X_calib`` (original-coordinate validation rows)."""
    def deco(fn):
        OPT_PASSES[name] = OptPass(name=name, fn=fn, doc=doc)
        return fn
    return deco


def opt_passes() -> tuple[str, ...]:
    """Registered pass names, in registration order."""
    return tuple(OPT_PASSES)


# optimization levels: O1 = structural shrink, O2 = + interface remap and
# cascade-aware ordering (the passes that change how callers' rows are
# consumed or how stages split, still behavior-preserving end to end)
OPT_LEVELS: dict[int, tuple[str, ...]] = {
    0: (),
    1: ("dedup_thresholds", "merge_equivalent_leaves", "compact"),
    2: ("dedup_thresholds", "merge_equivalent_leaves", "compact",
        "drop_unused_features", "reorder_trees"),
}

OptLike = Union[None, int, str, Sequence[str]]


def resolve_opt(opt: OptLike) -> tuple[tuple[str, ...], str]:
    """Normalize an ``opt=`` request → (pass names, candidate tag).

    Accepts a level (``2``, ``"O2"``, ``"-O2"``) or an explicit sequence
    of registered pass names; ``None`` means O0 (no passes)."""
    if opt is None:
        return (), "O0"
    if isinstance(opt, str):
        s = opt.lstrip("-")
        if s[:1] in ("O", "o"):
            s = s[1:]
        try:
            opt = int(s)
        except ValueError:
            raise ValueError(
                f"unknown opt level {opt!r} (use 0/1/2, 'O2', or a "
                f"sequence of pass names from {opt_passes()})") from None
    if isinstance(opt, (int, np.integer)):
        try:
            return OPT_LEVELS[int(opt)], f"O{int(opt)}"
        except KeyError:
            raise ValueError(f"unknown opt level {opt} "
                             f"(levels: {sorted(OPT_LEVELS)})") from None
    names = tuple(opt)
    unknown = [n for n in names if n not in OPT_PASSES]
    if unknown:
        raise ValueError(f"unknown optimizer pass(es) {unknown}; "
                         f"registered: {opt_passes()}")
    return names, "+".join(names)


# --------------------------------------------------------------------------- #
# Per-pass stats
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ForestStats:
    n_trees: int
    n_nodes: int                   # real internal nodes over the ensemble
    n_unique_splits: int           # unique (feature, threshold) pairs
    n_leaves: int                  # padded width L
    n_features: int
    max_depth: int

    @classmethod
    def of(cls, forest: Forest) -> "ForestStats":
        return cls(n_trees=forest.n_trees,
                   n_nodes=int(forest.n_nodes.sum()),
                   n_unique_splits=n_unique_splits(forest),
                   n_leaves=forest.n_leaves,
                   n_features=forest.n_features,
                   max_depth=forest.max_depth)


@dataclass(frozen=True)
class PassStats:
    """Before/after snapshot of one optimizer pass (plan-record payload)."""
    name: str
    before: ForestStats
    after: ForestStats

    def detail(self) -> str:
        b, a = self.before, self.after
        parts = [f"nodes {b.n_nodes}→{a.n_nodes}",
                 f"thr {b.n_unique_splits}→{a.n_unique_splits}"]
        if b.n_trees != a.n_trees:
            parts.append(f"T {b.n_trees}→{a.n_trees}")
        if b.n_leaves != a.n_leaves:
            parts.append(f"L {b.n_leaves}→{a.n_leaves}")
        if b.n_features != a.n_features:
            parts.append(f"d {b.n_features}→{a.n_features}")
        if b.max_depth != a.max_depth:
            parts.append(f"depth {b.max_depth}→{a.max_depth}")
        return ", ".join(parts)


@dataclass
class OptResult:
    forest: Forest
    stats: list = field(default_factory=list)   # [PassStats]
    tag: str = "O0"
    verified: Optional[str] = None   # "bit-exact" | "allclose" | None

    def describe(self) -> str:
        b = self.stats[0].before if self.stats else None
        a = self.stats[-1].after if self.stats else None
        if b is None:
            return f"{self.tag}: no passes"
        return (f"{self.tag}: {len(self.stats)} passes, "
                f"nodes {b.n_nodes}→{a.n_nodes}, "
                f"thr {b.n_unique_splits}→{a.n_unique_splits}, "
                f"verified {self.verified or 'off'}")


# --------------------------------------------------------------------------- #
# The five passes
# --------------------------------------------------------------------------- #
def _canon_threshold(t, is_float: bool):
    # -0.0 and +0.0 compare equal in every predicate but differ bitwise,
    # so they'd stay two entries in RapidScorer's unique-split table
    if is_float and t == 0:
        return type(t)(0.0)
    return t


@register_pass("dedup_thresholds",
               doc="canonicalize thresholds (-0.0→+0.0) and remove "
                   "dominated splits via per-feature interval reasoning")
def dedup_thresholds(forest: Forest, ctx: dict) -> Forest:
    is_float = np.issubdtype(forest.threshold.dtype, np.floating)

    def walk(nd: Node, bounds: dict) -> Node:
        if nd.is_leaf:
            return nd
        f = nd.feature
        t = _canon_threshold(nd.threshold, is_float)
        lo, hi = bounds.get(f, (-np.inf, np.inf))
        # reachable inputs satisfy lo < x[f] <= hi (finite inputs):
        # the predicate x <= t is decided when t covers the interval
        if t >= hi:
            return walk(nd.left, bounds)
        if t <= lo:
            return walk(nd.right, bounds)
        l = walk(nd.left, {**bounds, f: (lo, t)})
        r = walk(nd.right, {**bounds, f: (t, hi)})
        return Node(feature=f, threshold=t, left=l, right=r)

    roots = [walk(extract_tree(forest, t), {})
             for t in range(forest.n_trees)]
    return rebuild_forest(forest, roots)


@register_pass("merge_equivalent_leaves",
               doc="fold splits whose subtrees are bit-identical "
                   "constants into a single leaf (RapidScorer Table 4, "
                   "generalized to the IR)")
def merge_equivalent_leaves(forest: Forest, ctx: dict) -> Forest:
    def walk(nd: Node) -> Node:
        if nd.is_leaf:
            return nd
        l, r = walk(nd.left), walk(nd.right)
        if l.is_leaf and r.is_leaf and \
                l.value.tobytes() == r.value.tobytes():
            return l           # bit-identical either way → exact merge
        return Node(feature=nd.feature, threshold=nd.threshold,
                    left=l, right=r)

    roots = [walk(extract_tree(forest, t)) for t in range(forest.n_trees)]
    return rebuild_forest(forest, roots)


@register_pass("compact",
               doc="strip dead padding: drop unreachable nodes and "
                   "all-zero constant trees, shrink L to the real "
                   "maximum, recompute max_depth")
def compact(forest: Forest, ctx: dict) -> Forest:
    roots, kept = [], []
    for t in range(forest.n_trees):
        root = extract_tree(forest, t)
        if root.is_leaf and not root.value.any():
            continue           # contributes exactly 0 to every score
        roots.append(root)
        kept.append(t)
    if not roots:               # keep the forest well-formed (T >= 1)
        roots = [leaf(np.zeros(forest.n_classes,
                               dtype=forest.leaf_value.dtype))]
    return rebuild_forest(forest, roots,
                          n_leaves=max(count_leaves(r) for r in roots))


@register_pass("drop_unused_features",
               doc="remap the feature axis to the referenced columns; "
                   "Forest.feat_map keeps transform_inputs full-width")
def drop_unused_features(forest: Forest, ctx: dict) -> Forest:
    valid = forest.feature >= 0
    used = np.unique(forest.feature[valid]).astype(np.int64)
    if used.size == forest.n_features:
        return forest           # every column referenced — nothing to drop
    remap = np.full(forest.n_features, -1, dtype=forest.feature.dtype)
    remap[used] = np.arange(used.size, dtype=forest.feature.dtype)
    feature = np.where(valid, remap[np.maximum(forest.feature, 0)],
                       forest.feature.dtype.type(-1))
    # compose with an existing remap so feat_map always indexes the
    # caller's original row layout; the caller-side width is preserved
    # through compositions (n_features_in resolves the existing map's)
    feat_map = used if forest.feat_map is None \
        else np.asarray(forest.feat_map, dtype=np.int64)[used]
    return replace(
        forest, n_features=int(used.size), feature=feature,
        feat_map=feat_map, n_features_src=forest.n_features_in,
        feat_lo=None if forest.feat_lo is None else forest.feat_lo[used],
        feat_hi=None if forest.feat_hi is None else forest.feat_hi[used])


def per_tree_scores(forest: Forest, X: np.ndarray) -> np.ndarray:
    """(T, B, C) float64 per-tree oracle scores on IR-coordinate inputs
    (the ``reorder_trees`` cost model; also handy in tests)."""
    B = X.shape[0]
    out = np.zeros((forest.n_trees, B, forest.n_classes), dtype=np.float64)
    for t in range(forest.n_trees):
        if forest.n_nodes[t] == 0:
            out[t] = forest.leaf_value[t, 0]
            continue
        node = np.zeros(B, dtype=np.int32)
        done = np.zeros(B, dtype=bool)
        lf = np.zeros(B, dtype=np.int32)
        for _ in range(forest.max_depth + 1):
            f = forest.feature[t, node]
            go_left = X[np.arange(B), np.maximum(f, 0)] \
                <= forest.threshold[t, node]
            nxt = np.where(go_left, forest.left[t, node],
                           forest.right[t, node])
            is_leaf = nxt < 0
            lf = np.where(~done & is_leaf, -nxt - 1, lf)
            done |= is_leaf
            node = np.where(is_leaf, node, nxt)
            if done.all():
                break
        out[t] = forest.leaf_value[t, lf]
    return out


_REORDER_MAX_ROWS = 256            # cost-model rows (cheap, stable ranking)


@register_pass("reorder_trees",
               doc="discriminative-first tree order (validation-set "
                   "score variance; leaf-value spread fallback) so "
                   "cascade prefixes decide rows earlier")
def reorder_trees(forest: Forest, ctx: dict) -> Forest:
    X_val = (ctx or {}).get("X_calib")
    if X_val is not None and np.asarray(X_val).size:
        Xe = quantize_inputs(forest,
                             np.asarray(X_val)[:_REORDER_MAX_ROWS])
        S = per_tree_scores(forest, Xe)                     # (T, B, C)
        disc = ((S - S.mean(axis=1, keepdims=True)) ** 2).mean(axis=(1, 2))
    else:
        # data-free fallback: a tree's score can move a row by at most
        # its leaf-value spread — order by that bound
        lv = forest.leaf_value.astype(np.float64)
        real = np.arange(forest.n_leaves)[None, :] \
            < forest.n_leaves_per_tree[:, None]
        hi = np.where(real[..., None], lv, -np.inf).max(axis=1)
        lo = np.where(real[..., None], lv, np.inf).min(axis=1)
        disc = (hi - lo).sum(axis=1)
    order = np.argsort(-disc, kind="stable")
    if (order == np.arange(forest.n_trees)).all():
        return forest
    return replace(
        forest,
        feature=forest.feature[order], threshold=forest.threshold[order],
        left=forest.left[order], right=forest.right[order],
        leaf_lo=forest.leaf_lo[order], leaf_mid=forest.leaf_mid[order],
        leaf_hi=forest.leaf_hi[order], leaf_value=forest.leaf_value[order],
        n_nodes=forest.n_nodes[order],
        n_leaves_per_tree=forest.n_leaves_per_tree[order])


# --------------------------------------------------------------------------- #
# Oracle-equivalence verification (mandatory on every optimize() run)
# --------------------------------------------------------------------------- #
def _relative_map(before: Forest, after: Forest):
    """Column map from ``before``'s IR coordinates to ``after``'s (the
    delta the pass list added on top of any pre-existing feat_map)."""
    if after.feat_map is None:
        return None
    if before.feat_map is None:
        return np.asarray(after.feat_map, dtype=np.int64)
    pos = {int(c): i for i, c in enumerate(before.feat_map)}
    return np.array([pos[int(c)] for c in after.feat_map], dtype=np.int64)


def _check_inputs(forest: Forest, n_check: int, seed: int) -> np.ndarray:
    """Adversarial IR-coordinate inputs: random rows over the threshold
    range plus rows pinned exactly on each (finite) threshold — boundary
    rows are where a broken rewrite shows first."""
    rng = np.random.default_rng(seed)
    d = forest.n_features
    valid = forest.feature >= 0
    thr = forest.threshold[valid].astype(np.float64)
    thr = thr[np.isfinite(thr)]
    lo = float(thr.min()) - 2.0 if thr.size else -2.0
    hi = float(thr.max()) + 2.0 if thr.size else 2.0
    if np.issubdtype(forest.threshold.dtype, np.integer):
        X = rng.integers(int(np.floor(lo)), int(np.ceil(hi)) + 1,
                         size=(n_check, d)).astype(np.int64)
    else:
        X = rng.uniform(lo, hi, size=(n_check, d))
    if d:
        feats = np.maximum(forest.feature, 0)[valid]
        fin = np.isfinite(forest.threshold[valid].astype(np.float64))
        for i, (f, t) in enumerate(zip(feats[fin][:n_check],
                                       forest.threshold[valid][fin])):
            X[i, int(f)] = t
    return X


def verify_equivalence(before: Forest, after: Forest, *,
                       n_check: int = 64, seed: int = 0) -> str:
    """Check ``after`` computes the same scores as ``before`` — bit-exact
    when the leaf table is integer, within float-reassociation tolerance
    otherwise.  Raises ``OptimizationError`` on any divergence; returns
    the mode that held ("bit-exact" / "allclose")."""
    X = _check_inputs(before, n_check, seed)
    rel = _relative_map(before, after)
    Xa = X if rel is None else X[:, rel]
    got = after.predict_oracle(Xa)
    expect = before.predict_oracle(X)
    if np.issubdtype(before.leaf_value.dtype, np.integer):
        if not np.array_equal(got, expect):
            row = int(np.abs(got - expect).max(axis=1).argmax())
            raise OptimizationError(
                f"optimized forest diverges from the source oracle "
                f"(bit-exact contract, quantized leaves): row {row}, "
                f"{got[row]} vs {expect[row]}")
        return "bit-exact"
    if not np.allclose(got, expect, rtol=1e-5, atol=1e-7):
        err = float(np.abs(got - expect).max())
        raise OptimizationError(
            f"optimized forest diverges from the source oracle "
            f"(max |err| = {err:.3e} over {n_check} rows)")
    return "allclose"


# --------------------------------------------------------------------------- #
# The optimize entry point
# --------------------------------------------------------------------------- #
def optimize(forest: Forest, opt: OptLike = 1, *,
             ctx: Optional[dict] = None, verify: bool = True,
             n_check: int = 64, seed: int = 0) -> OptResult:
    """Run an optimization level (or explicit pass list) on ``forest``.

    Returns an ``OptResult`` carrying the optimized forest, per-pass
    before/after ``PassStats``, and the verification mode.  The compile
    pipeline's ``optimize`` pass (``compile_forest(..., opt=...)``) calls
    this and turns each ``PassStats`` into a ``CompilePlan`` record.

    ``verify=False`` skips the oracle check — for timing experiments
    only; the pipeline always verifies."""
    names, tag = resolve_opt(opt)
    ctx = ctx or {}
    out = forest
    stats: list[PassStats] = []
    before = ForestStats.of(forest) if names else None
    for name in names:
        out = OPT_PASSES[name].fn(out, ctx)
        after = ForestStats.of(out)   # carried forward: one scan per pass
        stats.append(PassStats(name, before, after))
        before = after
    mode = None
    if verify and names:
        mode = verify_equivalence(forest, out, n_check=n_check, seed=seed)
    return OptResult(forest=out, stats=stats, tag=tag, verified=mode)
