"""Learned autotuner cost model — numpy-only ridge ranker + confidence.

The ``-Os`` predictor (docs/AUTOTUNE.md): a regularized linear model on
engineered features of (forest shape × candidate axes × device), fit to
``log(us/instance)`` labels from the autotuner cache.  Log space makes
the model a *ranker* — a constant multiplicative error on every
candidate cancels out of the comparison — and makes the residual spread
directly interpretable as a relative-error band.

Features per (shape, candidate) row:

* numerics — log2(n_trees), log2(n_leaves), max_depth, log2(n_features),
  n_classes, log2(batch), n_devices, flint;
* one-hots — engine, quant tag, opt tag, layout tag, cascade tag,
  backend, device kind, device fingerprint, dtype (vocabulary fixed at
  fit time; an unseen value at predict time marks the candidate
  *unknown*);
* interactions — engine one-hot × every numeric, so each engine gets its
  own shape-scaling slopes (this is what lets the model flip the winner
  between e.g. ``qs-bitmm`` and ``unrolled`` as L grows — the paper's
  shape-dependence finding, learned).

Confidence is the Gaussian probability that the predicted top-1 really
beats the runner-up: with ``gap`` the predicted log-us margin and
``sigma`` the training residual std (floored at ``SIGMA_FLOOR`` so small
training sets cannot claim certainty), two independent errors give
``conf = Phi(gap / (sqrt(2) * sigma))``.  A candidate with
out-of-vocabulary tags cannot be ranked at all: confidence is reported
as ``-1.0``, below any threshold.

No sklearn, no scipy — closed-form ridge via ``np.linalg.solve`` and
``math.erf``.  Persisted as a versioned JSON artifact through
``repro_torch.io.packed.save_cost_model``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

from .extract import parse_candidate

NUMERIC = ("log_trees", "log_leaves", "depth", "log_features",
           "n_classes", "log_batch", "n_devices", "flint")
GROUPS = ("engine", "quant", "opt", "layout", "cascade", "backend",
          "device_kind", "fingerprint", "dtype")
SIGMA_FLOOR = 0.05        # log-units ≈ 5% relative error: the calibration
#                           floor that keeps tiny training sets honest


def _numeric(meta: dict, axes: dict) -> np.ndarray:
    return np.array([
        math.log2(max(float(meta.get("n_trees", 1)), 1.0)),
        math.log2(max(float(meta.get("n_leaves", 1)), 1.0)),
        float(meta.get("max_depth", 0)),
        math.log2(max(float(meta.get("n_features", 1)), 1.0)),
        float(meta.get("n_classes", 1)),
        math.log2(max(float(meta.get("batch", 1)), 1.0)),
        float(meta.get("n_devices", 1)),
        1.0 if axes.get("flint") else 0.0,
    ])


def _cat(meta: dict, axes: dict, group: str) -> str:
    src = axes if group in ("engine", "quant", "opt", "layout",
                            "cascade") else meta
    return str(src.get(group, ""))


def featurize(vocab: dict, meta: dict, axes: dict) -> tuple:
    """One (shape, candidate) pair → ``(feature vector, known)``.
    ``known`` is False when any categorical value falls outside the fit
    vocabulary — the model has never seen a row like this and its score
    for it is extrapolation, not prediction."""
    num = _numeric(meta, axes)
    parts = [num]
    known = True
    for g in GROUPS:
        vals = vocab.get(g, [])
        oh = np.zeros(len(vals))
        v = _cat(meta, axes, g)
        try:
            oh[vals.index(v)] = 1.0
        except ValueError:
            known = False
        parts.append(oh)
    engines = vocab.get("engine", [])
    inter = np.zeros((len(engines), num.size))
    e = _cat(meta, axes, "engine")
    if e in engines:
        inter[engines.index(e)] = num
    parts.append(inter.ravel())
    return np.concatenate(parts), known


@dataclass
class CostModel:
    """A fitted ranker: ``assess`` scores candidate names for a shape
    (via ``engine_select.shape_meta``); ``save``/``load`` round-trip the
    versioned JSON artifact."""
    weights: np.ndarray               # (D + 1,), trailing bias term
    mu: np.ndarray                    # (D,) feature standardization
    sd: np.ndarray
    resid_sigma: float                # training residual std, log-units
    vocab: dict                       # group → sorted value list
    n_rows: int = 0
    info: dict = field(default_factory=dict)

    def predict_log_us(self, meta: dict,
                       candidates: Sequence[str]) -> tuple:
        """Predicted ``log(us/instance)`` per candidate plus the
        per-candidate known mask."""
        X, known = [], []
        for c in candidates:
            x, k = featurize(self.vocab, meta, parse_candidate(c))
            X.append(x)
            known.append(k)
        Xs = (np.stack(X) - self.mu) / self.sd
        Xs = np.concatenate([Xs, np.ones((Xs.shape[0], 1))], axis=1)
        return Xs @ self.weights, np.array(known, dtype=bool)

    def assess(self, meta: dict, candidates: Sequence[str]) -> dict:
        """Rank ``candidates`` for the shape described by ``meta``.

        Returns ``{"us", "known", "order", "confidence"}``: predicted
        us/instance per candidate, the known mask, candidate indices
        sorted fastest-first (unknowns last), and the top-1 confidence —
        ``-1.0`` when the top pick itself is out-of-vocabulary (never
        trust it), otherwise ``Phi(gap / (sqrt(2)·sigma))`` against the
        best-ranked runner-up."""
        y, known = self.predict_log_us(meta, candidates)
        rank = np.where(known, y, np.inf)
        order = np.argsort(rank, kind="stable")
        i0 = int(order[0])
        if not known[i0]:
            conf = -1.0
        elif len(candidates) == 1:
            conf = 1.0
        else:
            i1 = int(order[1])
            if not known[i1]:
                conf = -1.0
            else:
                sigma = max(float(self.resid_sigma), SIGMA_FLOOR)
                z = float(y[i1] - y[i0]) / (math.sqrt(2.0) * sigma)
                conf = 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))
        return {"us": np.exp(y), "known": known, "order": order,
                "confidence": float(conf)}

    def save(self, path) -> str:
        from ..io import packed
        return packed.save_cost_model(path, {
            "numeric": list(NUMERIC), "groups": list(GROUPS),
            "weights": [float(w) for w in self.weights],
            "mu": [float(v) for v in self.mu],
            "sd": [float(v) for v in self.sd],
            "resid_sigma": float(self.resid_sigma),
            "vocab": {g: list(v) for g, v in self.vocab.items()},
            "n_rows": int(self.n_rows), "info": dict(self.info),
        })

    @classmethod
    def load(cls, path) -> "CostModel":
        from ..io import packed
        doc = packed.load_cost_model(path)
        if tuple(doc.get("numeric", ())) != NUMERIC or \
                tuple(doc.get("groups", ())) != GROUPS:
            raise ValueError(
                f"{path!r} was fit with a different feature layout "
                f"than this build understands — retrain "
                f"(repro_torch.tune.train_from_cache)")
        try:
            return cls(weights=np.asarray(doc["weights"], dtype=float),
                       mu=np.asarray(doc["mu"], dtype=float),
                       sd=np.asarray(doc["sd"], dtype=float),
                       resid_sigma=float(doc["resid_sigma"]),
                       vocab={g: list(v)
                              for g, v in doc["vocab"].items()},
                       n_rows=int(doc.get("n_rows", 0)),
                       info=dict(doc.get("info") or {}))
        except (KeyError, TypeError) as e:
            raise ValueError(f"{path!r}: malformed cost model: {e}") from e


def fit_cost_model(rows: list, l2: float = 1e-3) -> CostModel:
    """Closed-form ridge fit of ``log(us/instance)`` on the extracted
    rows (``repro_torch.tune.extract_rows``).  ``l2`` regularizes
    everything but the bias; the residual std becomes the confidence
    scale."""
    if len(rows) < 2:
        raise ValueError(
            f"need at least 2 training rows, got {len(rows)} — run some "
            "measured sweeps first (the cache is the training set)")
    vocab = {g: sorted({_cat(r["meta"], r["axes"], g) for r in rows})
             for g in GROUPS}
    X = np.stack([featurize(vocab, r["meta"], r["axes"])[0]
                  for r in rows])
    y = np.log(np.maximum(np.array([r["us"] for r in rows]), 1e-9))
    mu = X.mean(axis=0)
    sd = X.std(axis=0)
    sd[sd == 0.0] = 1.0
    Xs = np.concatenate([(X - mu) / sd, np.ones((X.shape[0], 1))], axis=1)
    A = Xs.T @ Xs + l2 * np.eye(Xs.shape[1])
    A[-1, -1] -= l2                  # unpenalized bias
    w = np.linalg.solve(A, Xs.T @ y)
    resid = y - Xs @ w
    sigma = float(np.sqrt(np.mean(resid ** 2)))
    return CostModel(weights=w, mu=mu, sd=sd,
                     resid_sigma=max(sigma, SIGMA_FLOOR), vocab=vocab,
                     n_rows=len(rows),
                     info={"l2": float(l2),
                           "label": "log_us_per_instance"})


def train_from_cache(cache_path=None, save_to=None,
                     l2: float = 1e-3) -> CostModel:
    """One-call training loop: extract rows from the autotuner cache
    (default: ``engine_select.default_cache_path()``), fit, and — when
    ``save_to`` is given — persist the artifact where
    ``choose(mode="predict")`` will find it (pass
    ``engine_select.default_model_path()`` for the default)."""
    from .extract import extract_rows
    model = fit_cost_model(extract_rows(cache_path), l2=l2)
    if save_to:
        model.save(save_to)
    return model
