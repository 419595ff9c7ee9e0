"""Importers: externally trained ensembles → canonical ``Forest`` IR.
The port's copy of ``repro.io.importers`` (numpy + json): every model file
imports to array-equal IR in both packages.

The paper evaluates forests trained elsewhere (sklearn / XGBoost /
LightGBM on a workstation) and deployed to the constrained target, so
model interchange is a front door, not an afterthought (InTreeger makes
the same argument for its integer-only pipeline).  Three sources:

  * ``import_sklearn`` — duck-typed over the sklearn estimator API
    (``estimators_`` + per-tree ``tree_`` arrays).  No sklearn import
    anywhere: a shim object with the same attributes works identically,
    which is how the golden-fixture tests run in containers without
    sklearn installed.
  * ``import_xgboost_json`` — XGBoost's ``dump_model``/``get_dump``
    JSON (list of recursive node dicts).  Pure-JSON parser, no xgboost
    dependency.
  * ``import_lightgbm_json`` — LightGBM's ``dump_model()`` JSON
    (``tree_info[*].tree_structure``).  Pure-JSON parser.

Split-semantics mapping (docs/FORMATS.md): the IR predicate is
``x <= t → left``.  sklearn and LightGBM already use ``<=``; XGBoost
uses ``x < t → yes``, which is mapped exactly for float32 comparisons by
``t' = nextafter(t, -inf)`` (the largest float32 below ``t``), so
``x < t  ⇔  x <= t'`` for every float32 ``x``.  Missing-value routing
(XGBoost ``missing``, LightGBM ``default_left``) is not modelled — the
engines assume fully observed features; importers reject NaN thresholds.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional, Sequence, Union

import numpy as np

from ..core.forest import Forest, from_trees
from ..trees.cart import Tree, TreeNode


def _tree_depth(root: TreeNode) -> int:
    if root.is_leaf:
        return 0
    return 1 + max(_tree_depth(root.left), _tree_depth(root.right))


def _count_leaves(root: TreeNode) -> int:
    if root.is_leaf:
        return 1
    return _count_leaves(root.left) + _count_leaves(root.right)


def _as_tree(root: TreeNode) -> Tree:
    return Tree(root, _count_leaves(root), _tree_depth(root))


def _strict_less_threshold(t: float) -> float:
    """Largest float32 below ``t``: maps ``x < t`` onto the IR's
    ``x <= t'`` exactly for float32 inputs.

    Exception: when that predecessor is subnormal (``|t|`` at or below
    the smallest normal float32), an engine that flushes subnormals to
    zero (the reference's XLA does) would silently turn it into ±0 and
    flip the boundary — clamp to the nearest FTZ-safe value instead
    (exact for all normal inputs), as the reference does, so both
    packages import the same thresholds."""
    if math.isnan(t):
        raise ValueError("NaN split threshold (missing-value routing is "
                         "not supported by the engines)")
    if math.isinf(t):
        return t
    prev = np.nextafter(np.float32(t), np.float32(-np.inf))
    tiny = np.finfo(np.float32).tiny
    if prev != 0 and abs(prev) < tiny:     # subnormal → FTZ hazard
        prev = np.float32(0.0) if t > 0 else np.float32(-tiny)
    return float(prev)


# --------------------------------------------------------------------------- #
# sklearn (duck-typed)
# --------------------------------------------------------------------------- #
def _sklearn_tree_to_node(tree, node: int, value_fn) -> TreeNode:
    """One sklearn ``tree_`` array bundle → TreeNode graph.

    ``tree`` needs ``children_left``, ``children_right``, ``feature``,
    ``threshold``, ``value`` (sklearn's ``Tree`` object or any shim).
    """
    left = int(tree.children_left[node])
    if left < 0:                                  # TREE_LEAF == -1
        return TreeNode(value=value_fn(np.asarray(tree.value[node])))
    right = int(tree.children_right[node])
    thr = float(tree.threshold[node])
    if math.isnan(thr):
        raise ValueError("NaN split threshold in sklearn tree")
    return TreeNode(feature=int(tree.feature[node]), threshold=thr,
                    left=_sklearn_tree_to_node(tree, left, value_fn),
                    right=_sklearn_tree_to_node(tree, right, value_fn))


def _estimator_trees(model) -> list:
    """``estimators_`` flattened to ``tree_`` bundles (GBT stores a 2-D
    object array of stage × output estimators)."""
    ests = np.asarray(model.estimators_, dtype=object).ravel().tolist()
    return [e.tree_ if hasattr(e, "tree_") else e for e in ests]


def import_sklearn(model, n_features: Optional[int] = None) -> Forest:
    """sklearn ``RandomForestClassifier`` / ``RandomForestRegressor`` /
    ``GradientBoostingRegressor`` (or any duck-typed equivalent) → IR.

    Dispatch is attribute-based (``learning_rate`` ⇒ boosting), so a shim
    carrying the same arrays imports identically — no sklearn import.
    Classifier forests average per-tree class distributions (the IR leaf
    holds ``proba / n_trees``, matching ``predict_proba``); regressor
    forests average raw leaf means; boosting sums ``learning_rate``-scaled
    leaves on top of the init constant.
    """
    trees = _estimator_trees(model)
    if not trees:
        raise ValueError("model has no estimators_ to import")
    T = len(trees)
    d = int(n_features if n_features is not None
            else getattr(model, "n_features_in_"))

    if hasattr(model, "learning_rate"):           # gradient boosting
        if int(getattr(model, "n_classes_", 0) or 0) >= 2:
            # GradientBoostingClassifier: multiclass stores a stage ×
            # class estimator grid that must NOT be summed into one
            # scalar, and even the binary case hides its log-odds prior
            # in an init_ without constant_ — refusing beats silently
            # shifted or garbage scores
            raise ValueError(
                "sklearn gradient-boosting *classifiers* are not "
                "supported (per-class logit grids / log-odds init priors) "
                "— export the booster as an XGBoost/LightGBM JSON dump "
                "and use those importers instead")
        lr = float(model.learning_rate)
        base = 0.0
        init = getattr(model, "init_", None)
        if init is not None and hasattr(init, "constant_"):
            base = float(np.ravel(init.constant_)[0])

        def value_fn(v):
            return np.asarray([float(v.ravel()[0]) * lr])

        roots = [_sklearn_tree_to_node(t, 0, value_fn) for t in trees]
        _check_n_features(d, roots)
        return from_trees([_as_tree(r) for r in roots], n_features=d,
                          n_classes=1, base_score=base)

    is_classifier = getattr(model, "n_classes_", 1) and \
        int(getattr(model, "n_classes_", 1)) > 1
    if is_classifier:
        C = int(model.n_classes_)

        def value_fn(v):
            counts = np.asarray(v, dtype=np.float64).ravel()[:C]
            tot = counts.sum()
            return (counts / tot if tot > 0 else
                    np.full(C, 1.0 / C)) / T
    else:
        C = 1

        def value_fn(v):
            return np.asarray([float(v.ravel()[0]) / T])

    roots = [_sklearn_tree_to_node(t, 0, value_fn) for t in trees]
    _check_n_features(d, roots)
    return from_trees([_as_tree(r) for r in roots], n_features=d,
                      n_classes=C)


# --------------------------------------------------------------------------- #
# XGBoost JSON dump
# --------------------------------------------------------------------------- #
def _xgb_feature_id(split, feat_map: dict, pinned: bool) -> int:
    """Split name → column index.  With caller-``pinned`` names every
    name (``fN`` included) resolves through the map — a miss is appended
    past the pinned range and rejected by the caller; unpinned, ``"f12"``
    parses to 12 and other names get first-appearance indices."""
    s = str(split)
    if s in feat_map:
        return feat_map[s]
    if not pinned and s.startswith("f") and s[1:].isdigit():
        return int(s[1:])
    return feat_map.setdefault(s, len(feat_map))


def _xgb_node(nd: dict, feat_map: dict, pinned: bool) -> TreeNode:
    if "leaf" in nd:
        return TreeNode(value=np.asarray([float(nd["leaf"])]))
    children = {c["nodeid"]: c for c in nd["children"]}
    yes, no = children[nd["yes"]], children[nd["no"]]
    # x < split_condition → yes (left); exact float32 mapping to <=
    thr = _strict_less_threshold(float(nd["split_condition"]))
    return TreeNode(feature=_xgb_feature_id(nd["split"], feat_map, pinned),
                    threshold=thr,
                    left=_xgb_node(yes, feat_map, pinned),
                    right=_xgb_node(no, feat_map, pinned))


def import_xgboost_json(dump: Union[str, Sequence], *,
                        n_features: Optional[int] = None,
                        n_classes: int = 1,
                        base_score: float = 0.0,
                        feature_names: Optional[Sequence[str]] = None
                        ) -> Forest:
    """XGBoost ``Booster.get_dump(dump_format="json")`` /
    ``dump_model(..., dump_format="json")`` output → IR.

    Accepts the parsed list of per-tree dicts, a list of per-tree JSON
    strings (``get_dump``'s return), or one JSON string holding the whole
    array.  ``n_classes > 1`` applies XGBoost's round-robin class
    assignment (tree ``i`` scores class ``i % n_classes``).  ``base_score``
    is not part of the dump — pass the booster's value if it matters
    (raw-score dumps only; sigmoid/softmax heads are the caller's job).
    ``feature_names`` fixes the name → column mapping for dumps with
    non-``fN`` split names (the booster's ``feature_names``, in training
    column order); without it, named features get first-appearance
    indices — fine for single-feature models, a silent column
    permutation otherwise.
    """
    if isinstance(dump, str):
        dump = json.loads(dump)
    trees_json = [json.loads(t) if isinstance(t, str) else t for t in dump]
    if not trees_json:
        raise ValueError("empty XGBoost dump (no trees)")
    pinned = feature_names is not None
    feat_map: dict = {str(n): i for i, n in enumerate(feature_names)} \
        if pinned else {}
    n_named = len(feat_map)
    roots = [_xgb_node(t, feat_map, pinned) for t in trees_json]
    if pinned and len(feat_map) > n_named:
        unknown = sorted(k for k, v in feat_map.items() if v >= n_named)
        raise ValueError(f"dump references features {unknown} missing from "
                         "feature_names")
    trees = [_as_tree(r) for r in roots]
    d = _check_n_features(n_features, roots) if n_features is not None \
        else max(_max_feature(roots) + 1, len(feat_map))
    if n_classes > 1:
        tree_class = [i % n_classes for i in range(len(trees))]
        forest = from_trees(trees, n_features=d, n_classes=n_classes,
                            tree_class=tree_class)
        if base_score:
            # every class margin carries the base: spread it over that
            # class's trees (each contributes exactly one leaf per row)
            counts = np.bincount(tree_class, minlength=n_classes)
            if (counts == 0).any():
                raise ValueError(
                    f"base_score={base_score} needs at least one tree per "
                    f"class (got {counts.tolist()} for {n_classes} classes)")
            for t in range(forest.n_trees):
                c = tree_class[t]
                nl = int(forest.n_leaves_per_tree[t])
                forest.leaf_value[t, :nl, c] += base_score / counts[c]
        return forest
    return from_trees(trees, n_features=d, n_classes=1,
                      base_score=base_score)


# --------------------------------------------------------------------------- #
# LightGBM JSON dump
# --------------------------------------------------------------------------- #
def _lgbm_node(nd: dict) -> TreeNode:
    if "leaf_value" in nd and "split_feature" not in nd:
        return TreeNode(value=np.asarray([float(nd["leaf_value"])]))
    dt = nd.get("decision_type", "<=")
    if dt != "<=":
        raise ValueError(f"unsupported LightGBM decision_type {dt!r} "
                         "(only numerical '<=' splits import)")
    thr = float(nd["threshold"])
    if math.isnan(thr):
        raise ValueError("NaN split threshold in LightGBM tree")
    return TreeNode(feature=int(nd["split_feature"]), threshold=thr,
                    left=_lgbm_node(nd["left_child"]),
                    right=_lgbm_node(nd["right_child"]))


def import_lightgbm_json(dump: Union[str, dict], *,
                         n_features: Optional[int] = None) -> Forest:
    """LightGBM ``Booster.dump_model()`` JSON (string or parsed dict) → IR.

    Multiclass models (``num_class > 1``) use LightGBM's round-robin tree
    → class layout; binary/regression objectives stay scalar (C=1, raw
    scores — apply the link function downstream if you need probabilities).
    """
    if isinstance(dump, str):
        dump = json.loads(dump)
    infos = dump.get("tree_info")
    if not infos:
        raise ValueError("not a LightGBM dump_model JSON (no tree_info)")
    roots = [_lgbm_node(t["tree_structure"]) for t in infos]
    trees = [_as_tree(r) for r in roots]
    C = int(dump.get("num_class", 1))
    if n_features is None:
        mfi = dump.get("max_feature_idx")
        n_features = (int(mfi) + 1 if mfi is not None
                      else _max_feature(roots) + 1)
    else:
        _check_n_features(int(n_features), roots)
    if C > 1:
        tree_class = [i % C for i in range(len(trees))]
        return from_trees(trees, n_features=int(n_features), n_classes=C,
                          tree_class=tree_class)
    return from_trees(trees, n_features=int(n_features), n_classes=1)


def _max_feature(roots: Sequence[TreeNode]) -> int:
    def walk(nd: TreeNode) -> int:
        if nd.is_leaf:
            return -1
        return max(nd.feature, walk(nd.left), walk(nd.right))
    return max((walk(r) for r in roots), default=-1)


def _check_n_features(d: int, roots: Sequence[TreeNode]) -> int:
    """An ``n_features`` hint below the max referenced index would make
    engines gather a clamped (wrong) column with no error — reject it."""
    mf = _max_feature(roots)
    if d <= mf:
        raise ValueError(f"n_features={d} is too small: the model "
                         f"references feature index {mf}")
    return d


# --------------------------------------------------------------------------- #
# Auto-detecting file loader
# --------------------------------------------------------------------------- #
def _accepted_kw(fn, kw: dict) -> dict:
    """Keep only the hints the matched importer's signature accepts —
    self-describing formats (packed npz, LightGBM's ``num_class``) carry
    their own metadata, so inapplicable hints are ignored, not fatal."""
    import inspect
    params = inspect.signature(fn).parameters
    return {k: v for k, v in kw.items() if k in params}


def load_model(path: Union[str, os.PathLike], **kw) -> Forest:
    """One front door for model files: sniffs the format and imports.

      * ``*.npz`` / ``*.repro.npz`` — packed IR (``io.packed``),
      * JSON array of node dicts    — XGBoost dump,
      * JSON object with ``tree_info``   — LightGBM dump,
      * JSON object with ``estimators``  — the sklearn-shim JSON the
        golden fixtures use (``sklearn_shim_from_json``).

    ``**kw`` holds importer hints (``n_classes``, ``feature_names``,
    ...); each hint reaches the matched importer only if its signature
    accepts it — formats that carry the metadata themselves ignore it.
    """
    path = os.fspath(path)
    if path.endswith(".npz"):
        from .packed import load_forest
        return load_forest(path)
    with open(path) as f:
        obj = json.load(f)
    if isinstance(obj, list):
        return import_xgboost_json(obj, **_accepted_kw(
            import_xgboost_json, kw))
    if isinstance(obj, dict) and "tree_info" in obj:
        return import_lightgbm_json(obj, **_accepted_kw(
            import_lightgbm_json, kw))
    if isinstance(obj, dict) and "estimators" in obj:
        return import_sklearn(sklearn_shim_from_json(obj), **_accepted_kw(
            import_sklearn, kw))
    raise ValueError(f"unrecognized model format in {path!r} (expected an "
                     "XGBoost JSON dump, a LightGBM dump_model JSON, a "
                     "sklearn-shim JSON, or a packed .npz)")


# --------------------------------------------------------------------------- #
# sklearn shim (fixture / file form of the duck-typed estimator API)
# --------------------------------------------------------------------------- #
class _ShimTree:
    """Array bundle quacking like ``DecisionTree*.tree_``."""

    def __init__(self, d: dict):
        self.children_left = np.asarray(d["children_left"], np.int64)
        self.children_right = np.asarray(d["children_right"], np.int64)
        self.feature = np.asarray(d["feature"], np.int64)
        self.threshold = np.asarray(d["threshold"], np.float64)
        self.value = np.asarray(d["value"], np.float64)


class _ShimModel:
    """Quacks like a fitted sklearn ensemble, built from plain JSON."""

    def __init__(self, d: dict):
        self.estimators_ = [_ShimTree(t) for t in d["estimators"]]
        self.n_features_in_ = int(d["n_features"])
        if "n_classes" in d:
            self.n_classes_ = int(d["n_classes"])
        if "learning_rate" in d:
            self.learning_rate = float(d["learning_rate"])
            if "init_constant" in d:
                self.init_ = type("Init", (), {
                    "constant_": np.asarray([d["init_constant"]])})()


def sklearn_shim_from_json(d: dict) -> _ShimModel:
    """JSON tree arrays → an object ``import_sklearn`` accepts — the
    serialized form of sklearn models for environments without sklearn
    (and the golden-fixture format under ``tests/fixtures/``)."""
    return _ShimModel(d)
