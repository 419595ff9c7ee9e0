"""repro_torch.cascade — confidence-gated staged ensemble evaluation; the
port's counterpart of ``repro.cascade``.

The forest is split into K tree-prefix stages compiled through the
ordinary engine registry; between stages a pluggable ``GatePolicy``
routes confident rows out early and gathers the rest into a shrinking,
power-of-two-bucketed batch.

Typical use::

    from repro_torch import core
    from repro_torch.cascade import CascadeSpec, calibrate

    pred = core.compile_forest(qforest, engine="bitvector", backend="cuda",
                               cascade=CascadeSpec(stages=(16, 64, 256)))
    result = calibrate(pred, X_val, y_val, floor_pp=0.5)
    pred.set_policy(result.policy)
    scores = pred.predict(X)            # early-exits confident rows
    pred.exit_fractions                 # per-stage exit accounting

``CascadeSpec(..., fused=True)`` lowers to ``FusedCascadePredictor``:
scores, gate and survivors stay on the device; on ``engine="bitvector"``
with ``backend="cuda"`` the whole cascade is one ``cascade_qs_forward``
launch per batch.
"""
from .fused import FusedCascadePredictor
from .policy import (CalibrationResult, GatePolicy, MarginGate, ProbaGate,
                     ScoreBoundGate, calibrate, default_policy_grid,
                     normalize_scores_torch, policy_from_header,
                     policy_to_header, simulate_gate)
from .predictor import (CascadePredictor, CascadeSpec, default_policy,
                        normalize_stages, tree_slice)

__all__ = [
    "GatePolicy", "MarginGate", "ProbaGate", "ScoreBoundGate",
    "CalibrationResult", "calibrate", "default_policy_grid",
    "normalize_scores_torch", "simulate_gate", "policy_to_header",
    "policy_from_header", "CascadePredictor", "FusedCascadePredictor",
    "CascadeSpec", "default_policy", "normalize_stages", "tree_slice",
]
