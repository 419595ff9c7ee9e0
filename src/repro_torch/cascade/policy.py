"""Gating policies for staged (cascade) ensemble evaluation — the port's
counterpart of ``repro.cascade.policy``.

Daghero et al. ("Dynamic Decision Tree Ensembles for Energy-Efficient
Inference on IoT Edge Nodes", PAPERS.md) observe that most inputs are
decided by a small prefix of the ensemble: a confidence gate between
stages routes only the hard inputs to the rest of the forest.

  * ``GatePolicy`` — the pluggable interface: ``prepare(forest, stages)``
    precomputes per-stage state from the host IR (numpy, as in the
    reference), ``decide(scores, stage)`` is the decision rule on torch
    f32 tensors of *cumulative* stage scores, and ``exits(scores, stage)``
    its numpy-facing wrapper, run on ``device`` (the cascade's device).
    The staged host loop and the generic fused tier run the same
    ``decide``, so their exit counts are identical by construction.
  * ``kernel_gate(n_stages)`` — the gate's device form for the CUDA
    cascade kernel (``kernels/csrc/cascade_qs_forward.cu``): its kind and
    every f32 constant, formed on the host exactly as ``decide`` forms
    it.  The three built-in gates have one; any other policy raises.
  * ``MarginGate`` / ``ProbaGate`` — heuristic confidence gates;
    ``ScoreBoundGate`` — sound early exit via remaining-score bounds
    (exact integer bounds on quantized forests).
  * ``calibrate()`` — picks the cheapest policy from a candidate grid
    whose held-out accuracy stays within ``floor_pp`` percentage points
    of the full forest, simulated on cumulative stage scores.

Every sum over classes runs left to right, in the order the CUDA kernel
takes, so a logit forest's softmax gives the same bits on the card in
both; on the CPU it meets the reference's XLA arithmetic.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, fields
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.forest import Forest
from ..core.quantize import leaf_scale
from ..core.registry import votes_mode

# gate kinds of the CUDA kernel (cascade_qs_forward.cu's GateKind)
GATE_NEVER, GATE_MARGIN, GATE_PROBA, GATE_SCORE_BOUND = 0, 1, 2, 3


def _row_sum(t: torch.Tensor) -> torch.Tensor:
    """(n, C) → (n, 1): the classes summed left to right."""
    tot = t[:, :1]
    for c in range(1, t.shape[1]):
        tot = tot + t[:, c:c + 1]
    return tot


def normalize_scores_torch(scores: torch.Tensor, votes: bool) -> torch.Tensor:
    """Torch twin of ``repro``'s ``normalize_scores_jnp`` in f32: vote
    counts normalize by total mass (all-zero rows fall back to uniform),
    margins/logits go through softmax.  It tolerates partial sums, so gate
    confidence and served ``predict_proba`` use the same rule.  Callers
    guard C >= 2."""
    s = scores.to(torch.float32)
    if votes:
        v = torch.clamp_min(s, 0.0)
        tot = _row_sum(v)
        uniform = torch.tensor(np.float32(1.0 / s.shape[1]),
                               device=s.device)
        return torch.where(tot > 0, v / torch.where(tot > 0, tot, 1.0),
                           uniform)
    m = s.max(dim=1, keepdim=True).values
    e = torch.exp(s - m)
    return e / _row_sum(e)


def _f32_down(x64: np.ndarray) -> np.ndarray:
    """f64 → f32 rounding toward -inf (exact values pass through)."""
    x32 = x64.astype(np.float32)
    hi = x32.astype(np.float64) > x64
    return np.where(hi, np.nextafter(x32, -np.inf), x32).astype(np.float32)


def _f32_up(x64: np.ndarray) -> np.ndarray:
    """f64 → f32 rounding toward +inf (exact values pass through)."""
    x32 = x64.astype(np.float32)
    lo = x32.astype(np.float64) < x64
    return np.where(lo, np.nextafter(x32, np.inf), x32).astype(np.float32)


def _argmax_onehot(s: torch.Tensor) -> torch.Tensor:
    """(n, C) → boolean one-hot of the *first* row maximum, as
    ``np.argmax`` breaks ties."""
    eq = s == s.max(dim=1, keepdim=True).values
    return eq & (torch.cumsum(eq.to(torch.int32), dim=1) == 1)


@dataclass
class KernelGate:
    """A gate's device form: ``kind`` (``GATE_*``), whether the forest's
    scores are votes, and its f32 constants in the kernel's order —
    threshold, uniform probability, C = 1 low and high decision bounds,
    slack, then ``rest_min`` and ``rest_max`` (n_stages - 1, C) row-major
    (score-bound gates only)."""
    kind: int
    votes: bool
    consts: np.ndarray
    _on_device: dict = field(default_factory=dict, repr=False, compare=False)

    def operands(self, inv_scale: float, device) -> torch.Tensor:
        """The kernel's f32 constant array on ``device``: ``inv_scale``
        then ``consts``; made once per (scale, device)."""
        key = (float(np.float32(inv_scale)), str(device))
        t = self._on_device.get(key)
        if t is None:
            a = np.concatenate([np.float32([inv_scale]), self.consts])
            t = self._on_device[key] = torch.from_numpy(
                a.astype(np.float32)).to(device)
        return t


def _gate_consts(threshold=0.0, uniform=0.0, lo=0.0, hi=0.0, slack=0.0,
                 rest=()) -> np.ndarray:
    head = np.array([threshold, uniform, lo, hi, slack], dtype=np.float32)
    return np.concatenate([head] + [np.asarray(r, dtype=np.float32).ravel()
                                    for r in rest])


@dataclass
class GatePolicy:
    """Interface: subclasses implement ``decide`` (and usually ``prepare``).

    ``prepare(forest, stages)`` is called once per cascade build with the
    host forest and the normalized stage boundaries (cumulative tree
    counts, last == n_trees).  ``decide(scores, stage)`` maps cumulative
    descaled scores (n, C) f32 tensor → boolean (n,) tensor, True exits
    now, with ``stage`` a Python int.

    ``exits(scores, stage)`` is the numpy-facing wrapper the staged host
    loop calls between stages: it runs ``decide`` on ``device`` (set by
    the cascade predictor; ``None`` is the CPU) on the unpadded rows.
    Third-party policies may override ``exits`` directly (numpy-only);
    those work with the staged ``CascadePredictor`` but cannot be fused."""

    #: where ``exits`` runs ``decide``; the cascade predictor sets it
    device = None

    def prepare(self, forest: Forest, stages: Sequence[int]) -> None:
        self._kernel_gate = None

    def decide(self, scores: torch.Tensor, stage: int) -> torch.Tensor:
        raise NotImplementedError(
            f"{type(self).__name__} defines no torch decide(); implement it "
            "(or override exits() and use the staged CascadePredictor — "
            "fused execution requires decide)")

    def exits(self, scores: np.ndarray, stage: int) -> np.ndarray:
        if scores.shape[0] == 0:
            return np.zeros(0, dtype=bool)
        s = torch.as_tensor(np.asarray(scores, dtype=np.float32),
                            device=self.device)
        return self.decide(s, stage).cpu().numpy()

    def kernel_gate(self, n_stages: int) -> KernelGate:
        """The gate's device form for the CUDA cascade kernel (cached per
        ``prepare``).  Only the built-in gates have one."""
        gate = getattr(self, "_kernel_gate", None)
        if gate is None:
            gate = self._kernel_gate = self._device_form(n_stages)
        return gate

    def _device_form(self, n_stages: int) -> KernelGate:
        raise NotImplementedError(
            f"{type(self).__name__} has no device form for the CUDA cascade "
            "kernel (only MarginGate, ProbaGate and ScoreBoundGate do); use "
            "fused=False or backend='torch'")

    def tag(self) -> str:
        """Short candidate-name tag (every init field participates)."""
        raise NotImplementedError


@dataclass
class MarginGate(GatePolicy):
    """Exit when the top-1 vs top-2 probability margin >= ``threshold``.

    ``threshold=inf`` never exits (gate disabled).  On C<2 forests no
    margin exists, so the gate never fires — use ``ScoreBoundGate``."""
    threshold: float = 0.9

    _votes: bool = field(default=True, init=False, repr=False, compare=False)
    _n_classes: int = field(default=1, init=False, repr=False, compare=False)

    _kind = GATE_MARGIN

    def prepare(self, forest: Forest, stages: Sequence[int]) -> None:
        super().prepare(forest, stages)
        self._votes = votes_mode(forest)
        self._n_classes = forest.n_classes

    def _never(self) -> bool:
        return self._n_classes < 2 or not np.isfinite(self.threshold)

    def decide(self, scores: torch.Tensor, stage: int) -> torch.Tensor:
        if self._never():
            return torch.zeros(scores.shape[0], dtype=torch.bool,
                               device=scores.device)
        p = normalize_scores_torch(scores, votes=self._votes)
        top = p.max(dim=1).values
        second = torch.where(_argmax_onehot(p), -torch.inf, p).max(
            dim=1).values
        return (top - second) >= torch.tensor(np.float32(self.threshold),
                                              device=p.device)

    def _device_form(self, n_stages: int) -> KernelGate:
        if self._never():
            return KernelGate(GATE_NEVER, self._votes, _gate_consts())
        return KernelGate(self._kind, self._votes, _gate_consts(
            threshold=np.float32(self.threshold),
            uniform=np.float32(1.0 / self._n_classes)))

    def tag(self) -> str:
        return f"margin{self.threshold:g}"


@dataclass
class ProbaGate(MarginGate):
    """Exit when the top-1 probability >= ``threshold``."""
    threshold: float = 0.95

    _kind = GATE_PROBA

    def decide(self, scores: torch.Tensor, stage: int) -> torch.Tensor:
        if self._never():
            return torch.zeros(scores.shape[0], dtype=torch.bool,
                               device=scores.device)
        p = normalize_scores_torch(scores, votes=self._votes)
        return p.max(dim=1).values >= torch.tensor(
            np.float32(self.threshold), device=p.device)

    def tag(self) -> str:
        return f"proba{self.threshold:g}"


@dataclass
class ScoreBoundGate(GatePolicy):
    """Sound early exit: remaining-score bounds from per-tree leaf
    min/max of the trees a row has not yet evaluated.

    After stage ``k`` a row's final score lies in
    ``[s + rest_min[k], s + rest_max[k]]`` componentwise.  A row exits
    when its decision provably cannot change: for C >= 2 the current
    argmax stays argmax even if every remaining tree votes worst-case
    against it; for C == 1 the score's side of ``decision`` is fixed.
    ``slack > 0`` relaxes soundness by that much score mass; ``slack = 0``
    keeps ``predict_class`` equal to the full forest's — exactly so on
    quantized forests (integer stage sums)."""
    slack: float = 0.0
    decision: float = 0.0

    _rest_min: Optional[np.ndarray] = field(default=None, init=False,
                                            repr=False, compare=False)
    _rest_max: Optional[np.ndarray] = field(default=None, init=False,
                                            repr=False, compare=False)

    def prepare(self, forest: Forest, stages: Sequence[int]) -> None:
        super().prepare(forest, stages)
        raw = np.asarray(forest.leaf_value)
        scale = leaf_scale(forest)
        T, L, C = raw.shape
        real = np.arange(L)[None, :] < \
            np.asarray(forest.n_leaves_per_tree)[:, None]       # (T, L)
        bounds = [int(min(s, T)) for s in stages]
        if np.issubdtype(raw.dtype, np.integer):
            # quantized forests: per-tree min/max and the suffix sums in
            # int64, the pow2 descale exact in f64; when every bound is
            # f32-representable the cast is value-exact and no outward
            # rounding is applied
            lv = raw.astype(np.int64)
            imin, imax = np.iinfo(np.int64).min, np.iinfo(np.int64).max
            tree_min = np.where(real[..., None], lv, imax).min(axis=1)
            tree_max = np.where(real[..., None], lv, imin).max(axis=1)
            zero = np.zeros((1, C), dtype=np.int64)
            suf_min = np.concatenate(
                [np.cumsum(tree_min[::-1], axis=0)[::-1], zero])
            suf_max = np.concatenate(
                [np.cumsum(tree_max[::-1], axis=0)[::-1], zero])
            rmin64 = np.stack([suf_min[b] for b in bounds]) / scale
            rmax64 = np.stack([suf_max[b] for b in bounds]) / scale
            rmin32 = rmin64.astype(np.float32)
            rmax32 = rmax64.astype(np.float32)
            if (np.all(rmin32.astype(np.float64) == rmin64)
                    and np.all(rmax32.astype(np.float64) == rmax64)):
                self._rest_min, self._rest_max = rmin32, rmax32
            else:        # bounds beyond f32's exact-integer range
                self._rest_min = _f32_down(rmin64)
                self._rest_max = _f32_up(rmax64)
            return
        lv = raw.astype(np.float64) / scale               # descaled, like scores
        tree_min = np.where(real[..., None], lv, np.inf).min(axis=1)   # (T, C)
        tree_max = np.where(real[..., None], lv, -np.inf).max(axis=1)
        suf_min = np.concatenate([np.cumsum(tree_min[::-1], axis=0)[::-1],
                                  np.zeros((1, C))])
        suf_max = np.concatenate([np.cumsum(tree_max[::-1], axis=0)[::-1],
                                  np.zeros((1, C))])
        # rounded outward: a round-to-nearest cast could shrink an
        # interval by 1 ulp and make a row exit unsoundly
        self._rest_min = _f32_down(np.stack([suf_min[b] for b in bounds]))
        self._rest_max = _f32_up(np.stack([suf_max[b] for b in bounds]))

    def _band(self):
        """C = 1 decision band as f32, formed as the reference's weakly
        typed ``decision -+ slack`` is."""
        return (np.float32(self.decision - self.slack),
                np.float32(self.decision + self.slack))

    def decide(self, scores: torch.Tensor, stage: int) -> torch.Tensor:
        s = scores.to(torch.float32)
        lo = s + torch.from_numpy(self._rest_min[stage]).to(s.device)
        hi = s + torch.from_numpy(self._rest_max[stage]).to(s.device)
        if s.shape[1] < 2:
            lo_thr, hi_thr = self._band()
            return (lo[:, 0] > torch.tensor(lo_thr, device=s.device)) | \
                (hi[:, 0] < torch.tensor(hi_thr, device=s.device))
        onehot = _argmax_onehot(s)
        best_lo = torch.where(onehot, lo, 0.0).sum(dim=1)
        other_hi = torch.where(onehot, -torch.inf, hi).max(dim=1).values
        return best_lo > other_hi - torch.tensor(np.float32(self.slack),
                                                 device=s.device)

    def _device_form(self, n_stages: int) -> KernelGate:
        lo, hi = self._band()
        g = n_stages - 1
        return KernelGate(GATE_SCORE_BOUND, True, _gate_consts(
            lo=lo, hi=hi, slack=np.float32(self.slack),
            rest=(self._rest_min[:g], self._rest_max[:g])))

    def tag(self) -> str:
        t = "bound"
        if self.slack:
            t += f"{self.slack:g}"
        if self.decision:
            t += f"@d{self.decision:g}"
        return t


# --------------------------------------------------------------------------- #
# (De)serialization of policy config
# --------------------------------------------------------------------------- #
def policy_to_header(policy: GatePolicy) -> dict:
    """Policy → JSON-safe header dict: class path + init-field scalars.
    Derived (``prepare``) state is rebuilt from the forest on load.
    Non-finite floats are encoded as tagged strings."""
    cfg = {}
    for f in fields(policy):
        if not f.init:
            continue
        v = getattr(policy, f.name)
        if not isinstance(v, (bool, int, float, str)) and v is not None:
            raise TypeError(f"policy field {f.name!r} of "
                            f"{type(policy).__name__} is not a scalar "
                            f"({type(v).__name__}) — cannot serialize")
        if isinstance(v, float) and not np.isfinite(v):
            v = {"__float__": repr(v)}          # 'inf' / '-inf' / 'nan'
        cfg[f.name] = v
    t = type(policy)
    return {"class": f"{t.__module__}:{t.__qualname__}", "config": cfg}


# the module a reference artifact names for its built-in gates: the port
# resolves those names among its own gates and never imports the path
_REFERENCE_POLICY_MODULE = "repro.cascade.policy"


def policy_from_header(h: dict) -> GatePolicy:
    mod, attr = h["class"].split(":")
    if mod == _REFERENCE_POLICY_MODULE:
        mod = __name__
    cls = getattr(importlib.import_module(mod), attr)
    if not (isinstance(cls, type) and issubclass(cls, GatePolicy)):
        raise ValueError(f"{h['class']!r} is not a GatePolicy subclass")
    cfg = {k: float(v["__float__"])
           if isinstance(v, dict) and "__float__" in v else v
           for k, v in h.get("config", {}).items()}
    return cls(**cfg)


# --------------------------------------------------------------------------- #
# Gate simulation + threshold calibration
# --------------------------------------------------------------------------- #
def simulate_gate(policy: GatePolicy, cum_scores: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Replay the gate on precomputed cumulative stage scores (K, B, C)
    (``CascadePredictor.cumulative_scores``).  Returns ``(exit_stage (B,),
    final_scores (B, C))`` — what a gated ``predict`` would produce.  The
    policy must already be ``prepare``'d for these stages."""
    K, B, C = cum_scores.shape
    exit_stage = np.full(B, K - 1, dtype=np.int64)
    active = np.ones(B, dtype=bool)
    for k in range(K - 1):
        idx = np.nonzero(active)[0]
        if idx.size == 0:
            break
        ex = policy.exits(cum_scores[k, idx], k)
        exit_stage[idx[ex]] = k
        active[idx[ex]] = False
    final = cum_scores[exit_stage, np.arange(B)]
    return exit_stage, final


@dataclass
class CalibrationResult:
    policy: GatePolicy            # winner (prepared for the stages)
    accuracy: float               # held-out accuracy of the gated cascade
    full_accuracy: float          # held-out accuracy of the full forest
    mean_trees: float             # mean trees evaluated per row (gated)
    exit_fractions: list          # per-stage exit fraction under the winner
    table: list                   # one dict per candidate policy tried

    @property
    def accuracy_drop_pp(self) -> float:
        return (self.full_accuracy - self.accuracy) * 100.0


def default_policy_grid() -> list:
    return [MarginGate(t) for t in
            (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99)] + [ScoreBoundGate()]


def calibrate(pred, X_val: np.ndarray, y_val: np.ndarray, *,
              policies: Optional[Sequence[GatePolicy]] = None,
              floor_pp: float = 0.5) -> CalibrationResult:
    """Pick the cheapest gate whose held-out accuracy stays within
    ``floor_pp`` percentage points of the full forest.

    ``pred`` is a ``CascadePredictor``; every candidate is simulated on one
    set of cumulative stage scores.  Among candidates with ``accuracy >=
    full_accuracy - floor_pp/100`` the fewest mean trees wins; if none
    qualifies the gate is disabled (``MarginGate(inf)``).  The returned
    policy is prepared; install it with ``pred.set_policy``."""
    y_val = np.asarray(y_val)
    cum = pred.cumulative_scores(X_val)                  # (K, B, C)
    stages = np.asarray(pred.stages, dtype=np.float64)
    full_cls = cum[-1].argmax(axis=1)
    full_acc = float((full_cls == y_val).mean())
    floor = full_acc - floor_pp / 100.0

    if policies is None:
        policies = default_policy_grid()
    candidates = list(policies) + [MarginGate(float("inf"))]  # safe fallback
    table = []
    best = None
    for pol in candidates:
        pol.prepare(pred.forest, pred.stages)
        exit_stage, final = simulate_gate(pol, cum)
        acc = float((final.argmax(axis=1) == y_val).mean())
        mean_trees = float(stages[exit_stage].mean())
        counts = np.bincount(exit_stage, minlength=len(pred.stages))
        row = {"policy": pol.tag(), "accuracy": acc,
               "mean_trees": mean_trees,
               "exit_fractions": (counts / max(len(y_val), 1)).tolist(),
               "ok": acc >= floor}
        table.append(row)
        if row["ok"] and (best is None
                          or mean_trees < best[0]
                          or (mean_trees == best[0] and acc > best[1])):
            best = (mean_trees, acc, pol, row)
    _, _, pol, row = best              # fallback always qualifies (acc==full)
    return CalibrationResult(policy=pol, accuracy=row["accuracy"],
                             full_accuracy=full_acc,
                             mean_trees=row["mean_trees"],
                             exit_fractions=row["exit_fractions"],
                             table=table)
